"""Data layer (twin of radnerf_tpu/data/): loaders that read a scene from
disk into numpy arrays on the host; the trainer moves the ray store to
its device and draws batches there.

`dataset_dict` has the reference's ten keys. The port loads `nsvf`,
`colmap` and `360v2`; the other seven raise NotImplementedError (ROADMAP.md
queue 1, item 1).
"""

from .base import BaseDataset  # noqa: F401


def _lazy(name):
    def load(*a, **k):
        import importlib

        mod, cls = name.rsplit(".", 1)
        return getattr(importlib.import_module(mod, __package__), cls)(*a, **k)

    return load


def _not_ported(key):
    def load(*a, **k):
        raise NotImplementedError(
            f"the '{key}' loader is not ported yet (ROADMAP.md queue 1, "
            "item 1: the remaining loaders)")

    return load


# the same keys as radnerf_tpu/data/__init__.py
dataset_dict = {
    "nerf": _not_ported("nerf"),
    "nsvf": _lazy(".nsvf.NSVFDataset"),
    "colmap": _lazy(".colmap.ColmapDataset"),
    "nerfpp": _not_ported("nerfpp"),
    "rtmv": _not_ported("rtmv"),
    "scannet": _not_ported("scannet"),
    "replica": _not_ported("replica"),
    "360v2": _lazy(".nerf360v2.NeRF360v2Dataset"),
    "mill19": _not_ported("mill19"),
    "eyeful": _not_ported("eyeful"),
}
