"""Training entry (twin of the top-level train.py):

    python -m radnerf_tpu_torch.train --root_dir .../Ignatius \
        --dataset_type nsvf --dataset_name TanksAndTemple \
        --scene_name Ignatius --exp_name base --num_epochs 20 \
        --batch_size 8192 --lr 1e-2 --scale 0.5

(scripts/base_TAT.sh's run: the single NGP field, the Instant-NGP
baseline). With --moe_training it trains the MoE, as
radnerf_tpu_torch.train_ml does. Trains on the CUDA device; `main(...,
device="cpu")` runs the same on the CPU with the kernels' plain
versions.
"""

from __future__ import annotations

from .. import DEFAULT_DEVICE
from ..opt import get_opts
from ..train_ml import run


def main(argv=None, device=DEFAULT_DEVICE, on_step=None):
    """Parse `argv` and `run` the system it names (the MoE with
    --moe_training, else the single field)."""
    return run(get_opts(argv), device, on_step)


if __name__ == "__main__":
    main().close()
