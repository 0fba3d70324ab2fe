"""MipNeRF-360 v2 loader (twin of radnerf_tpu/data/nerf360v2.py): a ColmapDataset
variant — name-sorted image permutation and `images_{1/downsample}`
pre-downsampled folders."""

from __future__ import annotations

from .colmap import ColmapDataset


class NeRF360v2Dataset(ColmapDataset):
    def _image_folder(self) -> str:
        if self.downsample < 1:
            return f"images_{int(1 / self.downsample)}"
        return "images"
