"""Offline evaluation / render harness (twin of the top-level oracle.py):
loads a checkpoint, renders a split (`test` or `test_traj`), writes the
images and prints mean PSNR / SSIM where there is ground truth.

    python -m radnerf_tpu_torch.oracle --root_dir ... --dataset_type nsvf \
        --split test --ckpt_path ckpts/.../epoch=19.ckpt --moe_training \
        --model_zoo_size 2

renders a MoE checkpoint; without --moe_training, a single field's
(train.py's).
"""

from __future__ import annotations

from . import DEFAULT_DEVICE
from .data import dataset_dict
from .opt import get_parser
from .train.trainer import NeRFSystem


def main(argv=None, device=DEFAULT_DEVICE) -> dict:
    """Render the --split (default `test`) from --ckpt_path or
    --weight_path; returns {"psnr", "ssim"} (None without ground
    truth)."""
    parser = get_parser()
    # the trainer restricts --split to train splits; the oracle renders
    # eval splits too (reference oracle.py:26 passes it straight through)
    for a in parser._actions:
        if a.dest == "split":
            a.choices = ["train", "trainval", "trainvaltest", "val", "test",
                         "test_traj"]
    parser.set_defaults(split="test")  # the split to RENDER
    hparams = parser.parse_args(argv)
    if not hparams.ckpt_path and not hparams.weight_path:
        raise ValueError("provide --ckpt_path or --weight_path")
    hparams.no_save_test = False
    render_split = hparams.split
    # the system's ray store always loads the train split; --split only
    # selects what is rendered
    hparams.split = "train"
    hparams.num_devices = 1     # one process renders; no ranks to start
    system = NeRFSystem(hparams, device=device)
    try:
        system.setup()
        if hparams.ckpt_path:
            system.resume(hparams.ckpt_path)
        if render_split != "test":
            system.test_dataset = dataset_dict[hparams.dataset_type](
                root_dir=hparams.root_dir, split=render_split,
                downsample=hparams.downsample,
            )
        metrics = system.validate(epoch=0)
    finally:
        system.close()
    if metrics["psnr"] is not None:
        print(f"PSNR: {metrics['psnr']:.3f}  SSIM: {metrics['ssim']:.4f}")
    print(f"renders written to {system.val_dir}")
    return metrics


if __name__ == "__main__":
    main()
