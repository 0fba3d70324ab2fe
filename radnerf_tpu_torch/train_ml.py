"""Rad-NeRF MoE training entry (twin of the top-level train_ml.py).

    python -m radnerf_tpu_torch.train_ml --root_dir .../Ignatius \
        --dataset_type nsvf --dataset_name TanksAndTemple \
        --scene_name Ignatius --exp_name rad --num_epochs 20 \
        --batch_size 8192 --lr 1e-2 --scale 0.5 --model_zoo_size 2 \
        --gate_type ray --depth_mutual_loss_w 5e-3 --cv_loss_w 1e-2

(scripts/rad_TAT.sh's ZOO=2 run). Trains on the CUDA device; `main(...,
device="cpu")` runs the same on the CPU with the kernels' plain
versions.
"""

from __future__ import annotations

from . import DEFAULT_DEVICE
from .opt import get_opts
from .train.trainer import NeRFSystem


def run(hparams, device=DEFAULT_DEVICE, on_step=None,
        system_cls=NeRFSystem) -> NeRFSystem:
    """Set up a `system_cls` (NeRFSystem or a subclass), resume
    (--ckpt_path, or --resume auto), then validate (--val_only) or train.
    `on_step(step, loss, aux)` is called after every training step.
    Returns the system."""
    if hparams.val_only and not hparams.ckpt_path:
        raise ValueError("You need to provide a @ckpt_path for validation!")
    system = system_cls(hparams, device=device)
    system.setup()
    if hparams.ckpt_path:
        system.resume(hparams.ckpt_path)
    elif hparams.resume == "auto":
        system.auto_resume()
    if hparams.val_only:
        system.validate(epoch=0)
    else:
        system.fit(on_step)
    return system


def main(argv=None, device=DEFAULT_DEVICE, on_step=None) -> NeRFSystem:
    """Parse `argv` and `run` the MoE system."""
    hparams = get_opts(argv)
    hparams.moe_training = True  # this entry is the canonical MoE path
    return run(hparams, device, on_step)


if __name__ == "__main__":
    main().close()
