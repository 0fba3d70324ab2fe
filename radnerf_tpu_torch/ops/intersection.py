"""Ray-AABB intersection (twin of radnerf_tpu/ops/intersection.py).

The render entry points intersect every ray with ONE box, the scene
bbox, so the slab test is a handful of elementwise tensor ops.
"""

from __future__ import annotations

import torch


def ray_aabb_intersect(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    centers: torch.Tensor,
    half_sizes: torch.Tensor,
) -> torch.Tensor:
    """Slab test of N rays against M axis-aligned boxes.

    Entry t is clamped to >= 0; rays that miss a box get t = (-1, -1).

    Args:
        rays_o, rays_d: (N, 3) ray origins and directions.
        centers, half_sizes: (M, 3) boxes.
    Returns:
        hits_t: (N, M, 2) [t_near, t_far] per (ray, box).
    """
    inv = (1.0 / rays_d)[:, None, :]
    o = rays_o[:, None, :]
    lo = (centers - half_sizes)[None, :, :]
    hi = (centers + half_sizes)[None, :, :]
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)       # (N, M)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    t_near = tmin.clamp_min(0.0)
    hit = tmax > t_near
    return torch.stack(
        [torch.where(hit, t_near, -1.0), torch.where(hit, tmax, -1.0)],
        dim=-1,
    )


def scene_near_far(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    center: torch.Tensor,
    half_size: torch.Tensor,
    near_distance: float = 0.01,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-box intersection with near-plane clamping.

    Returns (t1, t2), each (N,); t1 = -1 where the ray misses the box."""
    hits_t = ray_aabb_intersect(
        rays_o, rays_d, center[None, :], half_size[None, :]
    )[:, 0]
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    t1 = torch.where((t1 >= 0) & (t1 < near_distance), near_distance, t1)
    return t1, t2
