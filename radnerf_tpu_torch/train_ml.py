"""Rad-NeRF MoE training entry (twin of the top-level train_ml.py).

    python -m radnerf_tpu_torch.train_ml --root_dir .../Ignatius \
        --dataset_type nsvf --dataset_name TanksAndTemple \
        --scene_name Ignatius --exp_name rad --num_epochs 20 \
        --batch_size 8192 --lr 1e-2 --scale 0.5 --model_zoo_size 2 \
        --gate_type ray --depth_mutual_loss_w 5e-3 --cv_loss_w 1e-2

(scripts/rad_TAT.sh's ZOO=2 run). Trains on the CUDA device; `main(...,
device="cpu")` runs the same on the CPU with the kernels' plain
versions.

Data parallelism: --num_devices N trains on N ranks of this host, one a
card (0, the default: every card; on the CPU, N gloo ranks), started by
`run`. Across hosts, a launcher starts one process per card and each
joins its group with --multihost:

    torchrun --nnodes 2 --nproc_per_node 4 --rdzv_endpoint HOST:PORT \
        -m radnerf_tpu_torch.train_ml --multihost ...
"""

from __future__ import annotations

from . import DEFAULT_DEVICE
from .opt import get_opts
from .parallel.mesh import (
    distributed_is_initialized, launch, local_device_count,
)
from .train.trainer import NeRFSystem


def run(hparams, device=DEFAULT_DEVICE, on_step=None,
        system_cls=NeRFSystem) -> NeRFSystem:
    """Set up a `system_cls` (NeRFSystem or a subclass), resume
    (--ckpt_path, or --resume auto), then validate (--val_only) or train.
    `on_step(step, loss, aux)` is called after every training step.
    Returns the system.

    Where --num_devices asks for several ranks (0: every local card) and
    neither --multihost nor a group started them, ranks 1..N-1 are
    spawned (parallel.launch) and rank 0 runs here: the system returned
    and the steps `on_step` sees are rank 0's."""
    if hparams.val_only and not hparams.ckpt_path:
        raise ValueError("You need to provide a @ckpt_path for validation!")
    ranks = hparams.num_devices or local_device_count(device)
    if ranks > 1 and not (hparams.multihost
                          or distributed_is_initialized()):
        return launch(ranks, _other_rank, (hparams, device, system_cls),
                      device=device,
                      rank0=lambda: train(hparams, device, on_step,
                                          system_cls))
    return train(hparams, device, on_step, system_cls)


def _other_rank(hparams, device, system_cls) -> None:
    """A spawned rank of `run`: its system trained, then closed."""
    train(hparams, device, None, system_cls).close()


def train(hparams, device=DEFAULT_DEVICE, on_step=None,
          system_cls=NeRFSystem) -> NeRFSystem:
    """`run`'s work on this process's rank."""
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
