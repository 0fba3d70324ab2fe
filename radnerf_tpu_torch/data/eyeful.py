"""Eyeful Tower loader (twin of radnerf_tpu/data/eyeful.py, the
reference's datasets/eyeful.py): cameras.json KRT + splits.json; images
rescaled to 684x1024 (x downsample)."""

from __future__ import annotations

import json
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_images_with_decoder
from .ray_utils import get_ray_directions


class EyefulDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split, **kwargs)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, "cameras.json")) as f:
            meta = json.load(f)["KRT"]
        origin_width = meta[0]["width"]
        w, h = 684, 1024
        base_ds = origin_width / w
        K = np.array(meta[0]["K"], np.float64).T
        K[:2] /= base_ds
        K[:2] *= self.downsample
        w, h = int(w * self.downsample), int(h * self.downsample)
        self.K = K.astype(np.float32)
        self.directions = get_ray_directions(h, w, self.K).astype(np.float32)
        self.img_wh = (w, h)

    def read_meta(self, split, **kwargs):
        with open(os.path.join(self.root_dir, "splits.json")) as f:
            splits = json.load(f)
        wanted = set(splits["train" if split == "train" else "test"])
        with open(os.path.join(self.root_dir, "cameras.json")) as f:
            meta = json.load(f)["KRT"]
        poses, img_paths = [], []
        for frame in meta:
            if frame["cameraId"] not in wanted:
                continue
            w2c = np.array(frame["T"], np.float64).T
            c2w = np.linalg.inv(w2c)[:3]
            poses.append(c2w)
            img_paths.append(os.path.join(
                self.root_dir, "images", f"{frame['cameraId']}.jpg"))
        self.rays, self.decoder = read_images_with_decoder(
            img_paths, self.img_wh, native=False)
        self.poses = np.stack(poses).astype(np.float32)
