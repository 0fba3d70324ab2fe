"""Camera-ray geometry utilities (numpy, host-side).

Twin of radnerf_tpu/data/ray_utils.py (the reference's
datasets/ray_utils.py): pixel-center ray directions, Rodrigues
axis-angle, pose averaging and centering, and spheric test
trajectories. The trainer's differentiable twin of `axisangle_to_R`
(--optimize_ext) is train/trainer.py::torch_axisangle_to_R.
"""

from __future__ import annotations

import numpy as np


def get_ray_directions(
    H: int, W: int, K: np.ndarray, random: bool = False,
    return_uv: bool = False, flatten: bool = True,
    rng: np.random.Generator | None = None,
):
    """Ray directions for all pixels in camera frame [right down front].

    Matches ray_utils.py:8-42: pixel centers at u+0.5 (or uniform within the
    pixel when `random`).
    """
    u, v = np.meshgrid(
        np.arange(W, dtype=np.float32),
        np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if random:
        rng = rng or np.random.default_rng()
        du = rng.random(u.shape, dtype=np.float32)
        dv = rng.random(v.shape, dtype=np.float32)
    else:
        du = dv = 0.5
    directions = np.stack(
        [(u - cx + du) / fx, (v - cy + dv) / fy, np.ones_like(u)], -1
    )
    grid = np.stack([u, v], -1)
    if flatten:
        directions = directions.reshape(-1, 3)
        grid = grid.reshape(-1, 2)
    if return_uv:
        return directions, grid
    return directions


def axisangle_to_R(v: np.ndarray) -> np.ndarray:
    """Rodrigues formula (ray_utils.py:74-100). v: (B, 3) or (3,)."""
    single = v.ndim == 1
    if single:
        v = v[None]
    zero = np.zeros_like(v[:, :1])
    skew = np.stack(
        [
            np.concatenate([zero, -v[:, 2:3], v[:, 1:2]], 1),
            np.concatenate([v[:, 2:3], zero, -v[:, 0:1]], 1),
            np.concatenate([-v[:, 1:2], v[:, 0:1], zero], 1),
        ],
        axis=1,
    )
    norm = np.linalg.norm(v, axis=1)[:, None, None] + 1e-7
    eye = np.eye(3, dtype=v.dtype)[None]
    R = (
        eye
        + np.sin(norm) / norm * skew
        + (1 - np.cos(norm)) / norm**2 * (skew @ skew)
    )
    return R[0] if single else R


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray, pts3d: np.ndarray | None = None):
    """Average c2w pose (ray_utils.py:108-145): center = mean of points (or
    camera centers), z = mean forward, y up-hint from mean up."""
    if pts3d is not None:
        center = pts3d.mean(0)
    else:
        center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)  # (3, 4)


def center_poses(poses: np.ndarray, pts3d: np.ndarray | None = None):
    """Re-express all poses (and points) in the average-pose frame
    (ray_utils.py:148-178)."""
    pose_avg = average_poses(poses, pts3d)
    pose_avg_homo = np.eye(4, dtype=poses.dtype)
    pose_avg_homo[:3] = pose_avg
    inv = np.linalg.inv(pose_avg_homo)
    last_row = np.broadcast_to(
        np.array([0, 0, 0, 1], poses.dtype), (len(poses), 1, 4)
    )
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = (inv @ poses_homo)[:, :3]
    if pts3d is not None:
        pts3d_h = np.concatenate([pts3d, np.ones_like(pts3d[:, :1])], -1)
        return poses_centered, (inv @ pts3d_h.T).T[:, :3]
    return poses_centered, None


def create_spheric_poses(radius: float, mean_h: float, n_poses: int = 120):
    """Circular test trajectory (ray_utils.py:180-218)."""

    def spheric_pose(theta, phi, radius):
        trans_t = lambda t: np.array(
            [[1, 0, 0, 0], [0, 1, 0, 2 * mean_h], [0, 0, 1, -t]],
            dtype=np.float32,
        )
        rot_phi = lambda p: np.array(
            [
                [1, 0, 0, 0],
                [0, np.cos(p), -np.sin(p), 0],
                [0, np.sin(p), np.cos(p), 0],
            ],
            dtype=np.float32,
        )
        rot_theta = lambda t: np.array(
            [
                [np.cos(t), 0, -np.sin(t), 0],
                [0, 1, 0, 0],
                [np.sin(t), 0, np.cos(t), 0],
            ],
            dtype=np.float32,
        )
        c2w = rot_theta(theta) @ np.vstack(
            [rot_phi(phi) @ np.vstack([trans_t(radius), [0, 0, 0, 1]]),
             [0, 0, 0, 1]]
        )
        c2w = (
            np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0]],
                     dtype=np.float32)
            @ np.vstack([c2w, [0, 0, 0, 1]])
        )[:3]
        return c2w

    return np.stack(
        [
            spheric_pose(th, -np.pi / 12, radius)
            for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]
        ]
    )
