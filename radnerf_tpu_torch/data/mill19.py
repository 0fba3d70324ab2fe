"""Mega-NeRF Mill19 loader (twin of radnerf_tpu/data/mill19.py, the
reference's datasets/mill19.py): .pt metadata per image, coordinates.pt
origin_drb / pose_scale_factor, altitude offsets for building/rubble,
pose scale by min camera norm. Every split reads train/, as the
reference does."""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from .base import BaseDataset
from .color_utils import read_images_with_decoder
from .ray_utils import get_ray_directions


def _load_pt(path):
    return torch.load(path, map_location="cpu", weights_only=False)


class Mill19Dataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        exam = _load_pt(
            os.path.join(self.root_dir, "train/metadata/000001.pt")
        )
        ds = self.downsample
        w, h = int(exam["W"] * ds), int(exam["H"] * ds)
        fx = float(exam["intrinsics"][0]) * ds
        fy = float(exam["intrinsics"][1]) * ds
        self.K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K).astype(np.float32)
        self.img_wh = (w, h)
        if "building" in self.root_dir:
            self.ray_altitude_range = [8, 50]
        elif "rubble" in self.root_dir:
            self.ray_altitude_range = [11, 38]
        else:
            self.ray_altitude_range = [0, 0]
        coords = _load_pt(os.path.join(self.root_dir, "coordinates.pt"))
        self.origin_drb = np.asarray(coords["origin_drb"], np.float64)
        self.pose_scale_factor = float(coords["pose_scale_factor"])

    def _denorm_pose(self, c2w: np.ndarray) -> np.ndarray:
        c2w = np.asarray(c2w, np.float64).copy()
        c2w[:, 3] = c2w[:, 3] * self.pose_scale_factor + self.origin_drb
        c2w[0, 3] += self.ray_altitude_range[1]
        return c2w

    def read_meta(self, split):
        img_paths = sorted(
            glob.glob(os.path.join(self.root_dir, "train", "rgbs/*"))
        )
        pose_paths = sorted(
            glob.glob(os.path.join(self.root_dir, "train", "metadata/*"))
        )
        # global scale = min camera norm over all (denormalized) poses
        all_poses = np.stack(
            [self._denorm_pose(_load_pt(p)["c2w"]) for p in pose_paths]
        )
        self.scale = np.linalg.norm(all_poses[..., 3], axis=-1).min()

        n = min(len(img_paths), len(pose_paths))
        poses = []
        for pose_path in pose_paths[:n]:
            c2w = self._denorm_pose(_load_pt(pose_path)["c2w"])
            c2w[:, 3] /= self.scale
            poses.append(c2w)
        self.rays, self.decoder = read_images_with_decoder(
            img_paths[:n], self.img_wh, native=False)
        self.poses = np.stack(poses).astype(np.float32)
