"""Data layer (twin of radnerf_tpu/data/): loaders that read a scene from
disk into numpy arrays on the host; the trainer moves the ray store to
its device and draws batches there.

`dataset_dict` has the reference's ten keys, each a loader.
"""

from .base import BaseDataset  # noqa: F401


def _lazy(name):
    def load(*a, **k):
        import importlib

        mod, cls = name.rsplit(".", 1)
        return getattr(importlib.import_module(mod, __package__), cls)(*a, **k)

    return load


# the same keys as radnerf_tpu/data/__init__.py
dataset_dict = {
    "nerf": _lazy(".nerf.NeRFDataset"),
    "nsvf": _lazy(".nsvf.NSVFDataset"),
    "colmap": _lazy(".colmap.ColmapDataset"),
    "nerfpp": _lazy(".nerfpp.NeRFPPDataset"),
    "rtmv": _lazy(".rtmv.RTMVDataset"),
    "scannet": _lazy(".scannet.ScanNetDataset"),
    "replica": _lazy(".replica.ReplicaDataset"),
    "360v2": _lazy(".nerf360v2.NeRF360v2Dataset"),
    "mill19": _lazy(".mill19.Mill19Dataset"),
    "eyeful": _lazy(".eyeful.EyefulDataset"),
}
