"""Training entry (twin of the top-level train.py):

    python -m radnerf_tpu_torch.train --moe_training --root_dir ... \
        --dataset_type nsvf --model_zoo_size 2 ...

With --moe_training it drives the same NeRFSystem as
radnerf_tpu_torch.train_ml; without it, train.py trains a single NGP
field, which the port refuses with NotImplementedError (ROADMAP.md queue
1, item 5).
"""

from __future__ import annotations

from .. import DEFAULT_DEVICE
from ..opt import get_opts
from ..train_ml import run


def main(argv=None, device=DEFAULT_DEVICE, on_step=None):
    """Parse `argv` and `run` the system it names."""
    return run(get_opts(argv), device, on_step)


if __name__ == "__main__":
    main().close()
