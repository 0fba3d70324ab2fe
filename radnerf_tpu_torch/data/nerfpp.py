"""NeRF++ layout loader (twin of radnerf_tpu/data/nerfpp.py, the
reference's datasets/nerfpp.py): train/val/test dirs with rgb/, pose/,
intrinsics/ subfolders + camera_path trajectory. Used for unmasked
Tanks&Temples intermediate scenes (scripts/rad_tat.sh). The image size
comes from PIL where it is installed, else from the file's header."""

from __future__ import annotations

import glob
import os

import numpy as np

from .base import BaseDataset
from .color_utils import image_size, read_images_with_decoder
from .ray_utils import get_ray_directions


class NeRFPPDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split, **kwargs)

    def read_intrinsics(self):
        K = np.loadtxt(
            sorted(
                glob.glob(os.path.join(self.root_dir, "train/intrinsics/*.txt"))
            )[0],
            dtype=np.float32,
        ).reshape(4, 4)[:3, :3]
        K[:2] *= self.downsample
        w, h = image_size(
            sorted(glob.glob(os.path.join(self.root_dir, "train/rgb/*")))[0]
        )
        w, h = int(w * self.downsample), int(h * self.downsample)
        self.K = K
        self.directions = get_ray_directions(h, w, K).astype(np.float32)
        self.img_wh = (w, h)

    def read_meta(self, split, **kwargs):
        poses = []
        if split == "test_traj":
            pose_paths = sorted(
                glob.glob(os.path.join(self.root_dir, "camera_path/pose/*.txt"))
            )
            poses = [np.loadtxt(p).reshape(4, 4)[:3] for p in pose_paths]
        else:
            if split == "trainval":
                img_paths, pose_paths = [], []
                for s in ("train", "val"):
                    img_paths += sorted(
                        glob.glob(os.path.join(self.root_dir, s, "rgb/*"))
                    )
                    pose_paths += sorted(
                        glob.glob(os.path.join(self.root_dir, s, "pose/*.txt"))
                    )
            else:
                img_paths = sorted(
                    glob.glob(os.path.join(self.root_dir, split, "rgb/*"))
                )
                pose_paths = sorted(
                    glob.glob(os.path.join(self.root_dir, split, "pose/*.txt"))
                )
            n = min(len(img_paths), len(pose_paths))
            poses = [np.loadtxt(p).reshape(4, 4)[:3] for p in pose_paths[:n]]
            self.rays, self.decoder = read_images_with_decoder(
                img_paths[:n], self.img_wh, native=False)
        self.poses = np.stack(poses).astype(np.float32)
