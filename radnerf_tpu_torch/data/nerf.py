"""Blender transforms_*.json dataset loader (twin of
radnerf_tpu/data/nerf.py, the reference's datasets/nerf.py): 800x800
frames, focal from camera_angle_x, pose radius normalized to 1.5, with
the Jrender per-scene radius and shift table kept for parity."""

from __future__ import annotations

import json
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_images_with_decoder
from .ray_utils import get_ray_directions


class NeRFDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, "transforms_train.json")) as f:
            meta = json.load(f)
        w = h = int(800 * self.downsample)
        fx = fy = (
            0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"]) * self.downsample
        )
        self.K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K).astype(np.float32)
        self.img_wh = (w, h)

    def read_meta(self, split):
        if split == "trainval":
            frames = []
            for s in ("train", "val"):
                with open(
                    os.path.join(self.root_dir, f"transforms_{s}.json")
                ) as f:
                    frames += json.load(f)["frames"]
        else:
            with open(
                os.path.join(self.root_dir, f"transforms_{split}.json")
            ) as f:
                frames = json.load(f)["frames"]

        jrender = "Jrender_Dataset" in self.root_dir
        scene = os.path.basename(os.path.normpath(self.root_dir))
        poses, img_paths = [], []
        for frame in frames:
            c2w = np.array(frame["transform_matrix"], np.float32)[:3, :4]
            if jrender:
                c2w[:, :2] *= -1  # [left up front] -> [right down front]
                radius = {"Easyship": 1.2, "Scar": 1.8, "Coffee": 2.5,
                          "Car": 0.8}.get(scene, 1.5)
            else:
                c2w[:, 1:3] *= -1  # [right up back] -> [right down front]
                radius = 1.5
            c2w[:, 3] /= np.linalg.norm(c2w[:, 3]) / radius
            if jrender:
                if scene == "Coffee":
                    c2w[1, 3] -= 0.4465
                elif scene == "Car":
                    c2w[0, 3] -= 0.7
            poses.append(c2w)
            img_path = os.path.join(
                self.root_dir, f"{frame['file_path']}.png"
            )
            if os.path.exists(img_path):
                img_paths.append(img_path)
        if img_paths:
            self.rays, self.decoder = read_images_with_decoder(
                img_paths, self.img_wh, native=False)
        self.poses = np.stack(poses).astype(np.float32)
