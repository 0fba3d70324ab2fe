"""Point-cloud / pose geometry helpers (twin of
radnerf_tpu/data/geometry.py): percentile bbox with margin, and SLERP +
spline pose interpolation for test trajectories."""

from __future__ import annotations

import numpy as np


def get_bbox_from_points(
    points: np.ndarray, ignore_percentile: float = 0
) -> np.ndarray:
    """(2, d) bbox from per-axis percentiles, enlarged 5%
    (geometry.py:14-38)."""
    d = points.shape[1]
    bbox = np.zeros((2, d), np.float64)
    if points.size == 0:
        return bbox
    for i in range(d):
        bbox[:, i] = [
            np.percentile(points[:, i], ignore_percentile),
            np.percentile(points[:, i], 100 - ignore_percentile),
        ]
    center = bbox.mean(axis=0)
    extent = (bbox[1] - bbox[0]) * 1.05
    bbox[0] = center - extent / 2
    bbox[1] = center + extent / 2
    return bbox


def inter_poses(
    key_poses: np.ndarray, n_out_poses: int, sigma: float = 1.0
) -> np.ndarray:
    """Smooth trajectory through key c2w poses: SLERP for rotations +
    gaussian-smoothed linear interpolation for centers (the test_traj path
    of colmap scenes, geometry.py:74-173)."""
    from scipy.spatial.transform import Rotation, Slerp

    n_key = len(key_poses)
    key_times = np.linspace(0, 1, n_key)
    rots = Rotation.from_matrix(key_poses[:, :3, :3])
    slerp = Slerp(key_times, rots)
    out_times = np.linspace(0, 1, n_out_poses)
    out_R = slerp(out_times).as_matrix()

    centers = key_poses[:, :3, 3]
    out_c = np.stack(
        [np.interp(out_times, key_times, centers[:, i]) for i in range(3)], -1
    )
    if sigma > 0:  # smooth the path
        from scipy.ndimage import gaussian_filter1d

        out_c = gaussian_filter1d(out_c, sigma=sigma, axis=0, mode="nearest")
    out = np.zeros((n_out_poses, 3, 4), np.float32)
    out[:, :3, :3] = out_R
    out[:, :3, 3] = out_c
    return out
