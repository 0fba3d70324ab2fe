"""ScanNet loader (twin of radnerf_tpu/data/scannet.py, the reference's
datasets/scannet.py): intrinsics.txt + poses dir, 24px border unpad,
cube normalization by camera bbox + 2*SCANNET_FAR, every-16th test
split, inf-pose filtering."""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_images_with_decoder
from .geometry import inter_poses
from .ray_utils import get_ray_directions

SCANNET_FAR = 2.0


class ScanNetDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.unpad = 24
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        w, h = int(1296 * self.downsample), int(968 * self.downsample)
        K = np.loadtxt(
            os.path.join(self.root_dir, "intrinsics.txt"), dtype=np.float32
        )
        K[:2] *= self.downsample
        self.K = K[:3, :3]
        self.directions = get_ray_directions(h, w, self.K).astype(np.float32)
        self.img_wh = (w, h)

    def read_meta(self, split):
        all_img_paths = sorted(
            glob.glob(os.path.join(self.root_dir, "images", "*.jpg"))
        )
        all_pose_paths = sorted(
            glob.glob(os.path.join(self.root_dir, "poses", "*.txt"))
        )
        poses, img_paths = [], []
        for img_path, pose_path in zip(all_img_paths, all_pose_paths):
            c2w = np.loadtxt(pose_path)[:3]
            if np.isinf(c2w).sum() == 0:  # drop invalid tracked poses
                img_paths.append(img_path)
                poses.append(c2w)
        self.rays, self.decoder = read_images_with_decoder(
            img_paths, self.img_wh, unpad=self.unpad)
        poses = np.stack(poses)

        # cube-normalize by camera bbox + far margin (scannet.py:58-65)
        xyz_min = poses[..., 3].min(0)
        xyz_max = poses[..., 3].max(0)
        sbbox_scale = (xyz_max - xyz_min).max() + 2 * SCANNET_FAR
        sbbox_shift = (xyz_min + xyz_max) / 2
        poses[..., 3] -= sbbox_shift
        poses[..., 3] /= sbbox_scale

        if split == "train":
            ind = [i for i in range(len(img_paths)) if i % 16 != 0]
            poses, self.rays = poses[ind], self.rays[ind]
        elif split == "test":
            ind = [i for i in range(len(img_paths)) if i % 16 == 0]
            poses, self.rays = poses[ind], self.rays[ind]
        elif split == "test_traj":
            poses = inter_poses(poses, 1000, 20)
        self.poses = poses.astype(np.float32)
