"""NSVF-layout dataset loader (Synthetic-NeRF, BlendedMVS, Tanks&Temples).

Twin of radnerf_tpu/data/nsvf.py (the reference's datasets/nsvf.py):
bbox.txt scene bounds rescaled into [-0.5, 0.5]^3 (x1.05 margin),
intrinsics.txt, `0_/1_/2_`-prefixed split files, per-scene bound fixes
(Mic x1.2, Lego x1.1 — kept for dataset parity, SURVEY.md §8 quirk 9).
Primary dataset of the headline configs.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_images_with_decoder
from .ray_utils import get_ray_directions


class NSVFDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            xyz_min, xyz_max = np.loadtxt(
                os.path.join(root_dir, "bbox.txt")
            )[:6].reshape(2, 3)
            self.shift = (xyz_max + xyz_min) / 2
            self.scale = (xyz_max - xyz_min).max() / 2 * 1.05  # margin
            # per-scene bound fixes carried over from nsvf.py:26-27
            if "Mic" in self.root_dir:
                self.scale *= 1.2
            elif "Lego" in self.root_dir:
                self.scale *= 1.1
            self.read_meta(split)

    def read_intrinsics(self):
        root = self.root_dir
        ds = self.downsample
        if "Synthetic" in root or "Ignatius" in root:
            with open(os.path.join(root, "intrinsics.txt")) as f:
                fx = fy = float(f.readline().split()[0]) * ds
            if "Synthetic" in root:
                w = h = int(800 * ds)
            else:
                w, h = int(1920 * ds), int(1080 * ds)
            K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        else:
            K = np.loadtxt(
                os.path.join(root, "intrinsics.txt"), dtype=np.float32
            )[:3, :3]
            if "BlendedMVS" in root:
                w, h = int(768 * ds), int(576 * ds)
            elif "Tanks" in root:
                w, h = int(1920 * ds), int(1080 * ds)
            else:
                raise ValueError(f"unknown NSVF scene family: {root}")
            K[:2] *= ds
        self.K = K.astype(np.float32)
        self.directions = get_ray_directions(h, w, self.K).astype(np.float32)
        self.img_wh = (w, h)

    def _norm_pose(self, c2w: np.ndarray) -> np.ndarray:
        c2w = c2w.copy()
        c2w[:, 3] -= self.shift
        c2w[:, 3] /= 2 * self.scale  # scene inside [-0.5, 0.5]
        return c2w

    def read_meta(self, split):
        poses, rays = [], []
        if split == "test_traj":  # BlendedMVS / TanksAndTemples trajectories
            if "Ignatius" in self.root_dir:
                pose_files = sorted(
                    glob.glob(os.path.join(self.root_dir, "test_pose/*.txt"))
                )
                traj = [np.loadtxt(p) for p in pose_files]
            else:
                traj = np.loadtxt(
                    os.path.join(self.root_dir, "test_traj.txt")
                ).reshape(-1, 4, 4)
            for pose in traj:
                c2w = np.array(pose)[:3]
                c2w[:, 0] *= -1  # [left down front] -> [right down front]
                poses.append(self._norm_pose(c2w))
        else:
            prefix = {
                "train": "0_",
                "trainval": "[0-1]_",
                "trainvaltest": "[0-2]_",
                "val": "1_",
            }.get(split)
            if prefix is None:
                if "Synthetic" in self.root_dir:
                    prefix = "2_"  # synthetic test split
                elif split == "test":
                    prefix = "1_"  # real-scene test split
                else:
                    raise ValueError(f"{split} split not recognized!")
            img_paths = sorted(
                glob.glob(os.path.join(self.root_dir, "rgb", prefix + "*"))
            )
            pose_paths = sorted(
                glob.glob(os.path.join(self.root_dir, "pose", prefix + "*.txt"))
            )
            for pose_path in pose_paths:
                poses.append(self._norm_pose(np.loadtxt(pose_path)[:3]))
            self.rays, self.decoder = read_images_with_decoder(
                img_paths, self.img_wh)
            if "Jade" in self.root_dir or "Fountain" in self.root_dir:
                # black background -> white (nsvf.py:92-94)
                self.rays[np.all(self.rays <= 0.1, axis=-1)] = 1.0
        self.poses = np.stack(poses).astype(np.float32)
