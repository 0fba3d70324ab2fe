"""RTMV dataset loader (twin of radnerf_tpu/data/rtmv.py, the
reference's datasets/rtmv.py): per-frame json camera metadata; scene box
from 00000.json; splits by frame index (train 0-99, trainval 0-104, test
105-149)."""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_images_with_decoder
from .ray_utils import get_ray_directions


class RTMVDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, "00000.json")) as f:
            meta = json.load(f)["camera_data"]
        self.shift = np.array(meta["scene_center_3d_box"])
        self.scale = (
            np.array(meta["scene_max_3d_box"])
            - np.array(meta["scene_min_3d_box"])
        ).max() / 2 * 1.05
        ds = self.downsample
        fx = meta["intrinsics"]["fx"] * ds
        fy = meta["intrinsics"]["fy"] * ds
        cx = meta["intrinsics"]["cx"] * ds
        cy = meta["intrinsics"]["cy"] * ds
        w, h = int(meta["width"] * ds), int(meta["height"] * ds)
        self.K = np.float32([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K).astype(np.float32)
        self.img_wh = (w, h)

    def read_meta(self, split):
        ranges = {
            "train": (0, 100),
            "trainval": (0, 105),
            "test": (105, 150),
        }
        start, end = ranges.get(split, (0, 150))
        img_paths = sorted(
            glob.glob(os.path.join(self.root_dir, "images/*"))
        )[start:end]
        pose_paths = sorted(
            glob.glob(os.path.join(self.root_dir, "*.json"))
        )[start:end]
        n = min(len(img_paths), len(pose_paths))
        poses = []
        for pose_path in pose_paths[:n]:
            with open(pose_path) as f:
                p = json.load(f)["camera_data"]
            c2w = np.array(p["cam2world"]).T[:3]
            c2w[:, 1:3] *= -1
            if "bricks" in self.root_dir:
                c2w[:, 3] -= self.shift
                c2w[:, 3] /= 2 * self.scale  # bound in [-0.5, 0.5]
            poses.append(c2w)
        self.rays, self.decoder = read_images_with_decoder(
            img_paths[:n], self.img_wh, native=False)
        self.poses = np.stack(poses).astype(np.float32)
