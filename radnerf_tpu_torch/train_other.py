"""Training entry of the multi-submodel baselines (twin of the top-level
train_other.py): Switch-NeRF, Block-NeRF and Mega-NeRF.

    python -m radnerf_tpu_torch.train_other --root_dir .../Ignatius \
        --dataset_type nsvf --dataset_name TanksAndTemple \
        --scene_name Ignatius --exp_name switch_size2 \
        --model_type switch --model_zoo_size 2 --gate_type point \
        --num_epochs 20 --batch_size 8192 --lr 1e-2 --scale 0.5 \
        --cv_loss_w 1e-4

(scripts/switch_tat.sh's run; block_*.sh and mega_*.sh pass
--model_type block or mega). Trains on the CUDA device; `main(...,
device="cpu")` runs the same on the CPU with the kernels' plain
versions.
"""

from __future__ import annotations

from . import DEFAULT_DEVICE
from .opt import get_opts
from .train.other_trainer import OtherNeRFSystem
from .train_ml import run


def main(argv=None, device=DEFAULT_DEVICE, on_step=None) -> OtherNeRFSystem:
    """Parse `argv` and `train_ml.run` the baseline --model_type names:
    set up, resume, then validate (--val_only) or train."""
    hparams = get_opts(argv)
    assert hparams.model_type in ("switch", "block", "mega"), (
        f"--model_type must be switch|block|mega, got {hparams.model_type}"
    )
    return run(hparams, device, on_step, OtherNeRFSystem)


if __name__ == "__main__":
    main().close()
