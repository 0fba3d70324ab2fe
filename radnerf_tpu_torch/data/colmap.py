"""COLMAP sparse-model dataset loader.

Twin of radnerf_tpu/data/colmap.py (the reference's datasets/colmap.py):
read intrinsics/extrinsics/points from sparse/0/*.bin, center poses in the
average-camera frame, scale by the minimum camera norm, compute per-image
depth bounds + visibility (`cal_bds`), derive the scene bbox from
sufficiently-visible points, and split every 8th image as test (few-shot
via num_view).
"""

from __future__ import annotations

import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_images_with_decoder
from .colmap_utils import (
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)
from .geometry import get_bbox_from_points, inter_poses
from .ray_utils import center_poses, create_spheric_poses, get_ray_directions


class ColmapDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split, **kwargs)

    # -- intrinsics (colmap.py:28-52) -------------------------------------
    def read_intrinsics(self):
        camdata = read_cameras_binary(
            os.path.join(self.root_dir, "sparse/0/cameras.bin")
        )
        cam = camdata[min(camdata)]
        h = int(cam.height * self.downsample)
        w = int(cam.width * self.downsample)
        self.img_wh = (w, h)
        if cam.model in ("SIMPLE_RADIAL", "SIMPLE_PINHOLE"):
            fx = fy = cam.params[0] * self.downsample
            cx = cam.params[1] * self.downsample
            cy = cam.params[2] * self.downsample
        elif cam.model in ("PINHOLE", "OPENCV"):
            fx = cam.params[0] * self.downsample
            fy = cam.params[1] * self.downsample
            cx = cam.params[2] * self.downsample
            cy = cam.params[3] * self.downsample
        else:
            raise ValueError(f"unsupported camera model {cam.model}")
        self.fx, self.fy = fx, fy
        self.K = np.float32([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K).astype(np.float32)

    def _image_folder(self) -> str:
        if "360_v2" in self.root_dir and self.downsample < 1:
            return f"images_{int(1 / self.downsample)}"
        return "images"

    # -- depth bounds + visibility (colmap.py:141-178) ---------------------
    def cal_bds(self, poses, pts3d, imdata):
        id_list = list(imdata.keys())
        n_img = poses.shape[0]
        pts_arr = np.array([pts3d[k].xyz for k in pts3d])
        vis_arr = np.zeros((len(pts3d), n_img), np.int32)
        for row, k in enumerate(pts3d):
            for ind in pts3d[k].image_ids:
                act = id_list.index(ind)
                vis_arr[row, act - 1] = 1
        # z-depth of each point in each camera (LLFF axis shuffle)
        z_axis = poses[:, :3, 2]  # (M, 3) camera forward
        centers = poses[:, :3, 3]
        zvals = np.einsum(
            "pmc,mc->pm", pts_arr[:, None, :] - centers[None], -(-z_axis)
        )
        bds = []
        valid_mask = np.ones(n_img)
        for i in range(n_img):
            zs = zvals[vis_arr[:, i] == 1, i]
            if len(zs) == 0:
                valid_mask[i] = 0
                bds.append(np.array([1.0, 100.0]))
                continue
            close, far = np.percentile(zs, 0.5), np.percentile(zs, 99.5)
            if close > 0 and far > 0:
                bds.append(np.array([close, far]))
            else:
                valid_mask[i] = 0
                bds.append(np.array([1.0, 100.0]))
        return np.array(bds), vis_arr

    # -- main meta (colmap.py:54-139) --------------------------------------
    def read_meta(self, split, **kwargs):
        imdata = read_images_binary(
            os.path.join(self.root_dir, "sparse/0/images.bin")
        )
        img_names = [imdata[k].name for k in imdata]
        folder = self._image_folder()
        img_paths = []
        self.exist_ind = np.zeros(len(img_names))
        for i, name in enumerate(img_names):
            p = os.path.join(self.root_dir, folder, name)
            if os.path.exists(p):
                self.exist_ind[i] = 1
                img_paths.append(p)

        bottom = np.array([[0, 0, 0, 1.0]])
        w2c = np.stack(
            [
                np.concatenate(
                    [
                        np.concatenate(
                            [imdata[k].qvec2rotmat(),
                             imdata[k].tvec.reshape(3, 1)],
                            1,
                        ),
                        bottom,
                    ],
                    0,
                )
                for k in imdata
            ]
        )
        poses = np.linalg.inv(w2c)[:, :3]  # c2w

        pts3d = read_points3d_binary(
            os.path.join(self.root_dir, "sparse/0/points3D.bin")
        )
        self.bds, self.vis_arr = self.cal_bds(poses, pts3d, imdata)

        pts = np.array([pts3d[k].xyz for k in pts3d])
        self.poses, self.pts3d = center_poses(poses, pts)
        self.scale = np.linalg.norm(self.poses[..., 3], axis=-1).min()
        self.poses[..., 3] /= self.scale
        self.pts3d /= self.scale

        # bbox from points visible in >= 1 existing image (colmap.py:94-96)
        vis_count = self.vis_arr[:, self.exist_ind == 1].sum(-1)
        self.bbox = get_bbox_from_points(self.pts3d[vis_count >= 1])

        if split == "test_traj":
            if "360_v2" in self.root_dir:
                self.poses = create_spheric_poses(
                    1.2, self.poses[:, 1, 3].mean()
                ).astype(np.float32)
            elif "free" in self.root_dir:
                self.poses = inter_poses(self.poses, 200, 10)
            self.rays = np.zeros((0, 0, 3), np.float32)
            return

        existing_poses = self.poses[self.exist_ind == 1]
        if split == "train":
            keep = [i for i in range(len(img_paths)) if i % 8 != 0]
        else:  # every 8th image as test (colmap.py:107-125)
            keep = [i for i in range(len(img_paths)) if i % 8 == 0]
        img_paths = [img_paths[i] for i in keep]
        self.poses = existing_poses[keep]

        num_view = kwargs.get("num_view", 0)
        if split == "train" and num_view > 0:  # few-shot setting
            index = np.random.choice(
                len(img_paths), num_view, replace=False
            )
            img_paths = [img_paths[i] for i in index]
            self.poses = self.poses[index]

        self.rays, self.decoder = read_images_with_decoder(
            img_paths, self.img_wh, blend_a=False)
        self.poses = self.poses.astype(np.float32)
