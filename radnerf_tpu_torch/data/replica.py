"""Replica loader (twin of radnerf_tpu/data/replica.py). The reference's
loader is dead code: its constructor passes 4 arguments to the 3-argument
base (replica.py:15). The JAX package fixes the signature and keeps the
rest of its semantics, and so does this twin: transforms.json
intrinsics, images/poses dirs, alternating train/test split, traj.txt
test trajectory."""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_images_with_decoder
from .ray_utils import get_ray_directions


class ReplicaDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0,
                 load_depth=False, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.load_depth = load_depth
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, "transforms.json")) as fp:
            metas = json.load(fp)
        ds = self.downsample
        w, h = int(metas["w"] * ds), int(metas["h"] * ds)
        fx, fy = metas["fl_x"] * ds, metas["fl_y"] * ds
        self.K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
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
            if np.isinf(c2w).sum() == 0:
                poses.append(c2w)
                img_paths.append(img_path)
        self.rays, self.decoder = read_images_with_decoder(
            img_paths, self.img_wh, native=False)
        poses = np.stack(poses)

        if split == "train":
            ind = [i for i in range(len(poses)) if i % 2 == 0]
            poses, self.rays = poses[ind], self.rays[ind]
        elif split == "test":
            ind = [i for i in range(len(poses)) if i % 2 != 0]
            poses, self.rays = poses[ind], self.rays[ind]
        elif split == "test_traj":
            poses = np.loadtxt(
                os.path.join(self.root_dir, "traj.txt")
            ).reshape(-1, 4, 4)[:, :3]
        self.poses = poses.astype(np.float32)
