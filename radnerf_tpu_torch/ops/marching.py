"""Occupancy-grid ray marching on the closed-form sample lattice (twin of
radnerf_tpu/ops/marching.py: the test-time marches and the training-time
marches of one grid and of the union of K grids).

The CUDA marcher's step schedule t_{k+1} = t_k + clamp(t_k * f, dt_min,
dt_max) is a deterministic lattice of the start t, so a block of K
candidates per ray is evaluated in closed form, occupancy-tested in
parallel, and the kept ones compacted: into a flat static-CSR buffer, or
into dense (N, S) rows (the first S kept candidates of each ray, by a
per-row binary search of the running count).

`occupancy_lookup_bricks` launches the CUDA kernel `csrc/occ_lookup.cu` on
CUDA tensors and runs `occupancy_lookup` (the same function: it is the
kernel's plain twin) on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import kernels
from .fma import fma32

SQRT3 = math.sqrt(3.0)


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Static marching parameters (shapes and schedule constants)."""

    scale: float = 0.5
    cascades: int = 1
    grid_size: int = 128
    exp_step_factor: float = 0.0
    max_samples: int = 1024
    samples_per_ray: int = 128
    n_candidates: int = 0

    @property
    def dt_min(self) -> float:
        return SQRT3 / self.max_samples

    @property
    def dt_max(self) -> float:
        return SQRT3 * 2.0 * self.scale / self.grid_size

    @property
    def k_candidates(self) -> int:
        if self.n_candidates > 0:
            return self.n_candidates
        if self.exp_step_factor == 0.0:
            return min(
                self.max_samples,
                int(math.ceil(2.0 * self.scale * self.max_samples)) + 1,
            )
        f = self.exp_step_factor
        t_a, t_b = self.dt_min / f, self.dt_max / f
        t_end = 2.0 * self.scale * SQRT3
        k = t_a / self.dt_min
        if t_end > t_a:
            k += math.log(min(t_end, t_b) / t_a) / math.log1p(f)
        if t_end > t_b:
            k += (t_end - t_b) / self.dt_max
        return int(math.ceil(k)) + 8


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def sample_lattice(
    t_start: torch.Tensor, k: torch.Tensor, cfg: MarchConfig
) -> torch.Tensor:
    """Closed-form lattice position t_k: k applications of
    t <- t + clamp(t * f, dt_min, dt_max), broadcasting t_start and k."""
    f = cfg.exp_step_factor
    dt_min, dt_max = cfg.dt_min, cfg.dt_max
    kf = k.to(torch.float32)
    if f == 0.0:
        return fma32(kf, dt_min, t_start)
    dev = t_start.device
    t_a, t_b = _f32(dt_min / f).to(dev), _f32(dt_max / f).to(dev)
    log1pf = _f32(math.log1p(f)).to(dev)
    # phase A: linear steps of dt_min while t < t_a
    kA = torch.ceil((t_a - t_start) / _f32(dt_min).to(dev)).clamp_min(0.0)
    tA = fma32(kA, dt_min, t_start)
    # phase B: geometric growth by (1 + f) while t < t_b
    kB = torch.ceil(
        torch.log(torch.clamp_min(t_b / tA, 1e-12)) / log1pf
    ).clamp_min(0.0)
    tB = tA * torch.exp(kB * log1pf)
    # phase C: linear steps of dt_max
    t_lin = fma32(kf, dt_min, t_start)
    t_geo = tA * torch.exp((kf - kA) * log1pf)
    t_far = fma32(kf - kA - kB, dt_max, tB)
    return torch.where(
        kf <= kA, t_lin, torch.where(kf <= kA + kB, t_geo, t_far)
    )


def calc_dt(t: torch.Tensor, cfg: MarchConfig) -> torch.Tensor:
    """Step size at distance t."""
    return torch.clamp(t * cfg.exp_step_factor, cfg.dt_min, cfg.dt_max)


def _occ_mip_cell(
    xyz: torch.Tensor, dt: torch.Tensor, cfg: MarchConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mip, integer cell coords (..., 3)) of the multi-cascade grid."""
    C, G = cfg.cascades, cfg.grid_size
    mx = xyz.abs().amax(dim=-1)
    # mip_from_pos: frexp exponent of max|xyz|, + 1
    m1 = (torch.frexp(mx).exponent + 1).clamp(0, C - 1)
    # mip_from_dt: frexp exponent of dt * G
    m2 = torch.frexp(dt * G).exponent.clamp(0, C - 1)
    mip = torch.maximum(m1, m2)
    # min(2^(mip-1), scale) from a table: exact powers of two
    bounds = torch.tensor(
        [min(2.0 ** (m - 1), cfg.scale) for m in range(C)],
        dtype=torch.float32, device=xyz.device,
    )
    mip_bound = bounds[mip.long()]
    n = torch.clamp(
        0.5 * (xyz / mip_bound[..., None] + 1.0) * G, 0.0, G - 1.0
    ).to(torch.int32)
    return mip, n


def _occ_flat_index(
    xyz: torch.Tensor, dt: torch.Tensor, cfg: MarchConfig
) -> torch.Tensor:
    """(mip, cell) flat index of the multi-cascade occupancy grid."""
    G = cfg.grid_size
    mip, n = _occ_mip_cell(xyz, dt, cfg)
    mip = mip.to(torch.int64)
    n = n.to(torch.int64)
    return ((mip * G + n[..., 0]) * G + n[..., 1]) * G + n[..., 2]


def occupancy_lookup(
    xyz: torch.Tensor, dt: torch.Tensor, occ_grid: torch.Tensor,
    cfg: MarchConfig,
) -> torch.Tensor:
    """Multi-cascade occupancy test: xyz (..., 3), dt (...,), occ_grid
    (C, G, G, G) bool -> (...,) bool."""
    return occ_grid.reshape(-1)[_occ_flat_index(xyz, dt, cfg)]


OCC_BRICK = (4, 4, 8)     # occupancy brick-row cell dims (x, y, z) = 128


def pack_occ_bricks(occ_grid: torch.Tensor) -> torch.Tensor:
    """(C, G, G, G) bool -> (C*(G/4)*(G/4)*(G/8), 128) bf16 brick rows,
    lane = (x & 3) + 4 (y & 3) + 16 (z & 7): the reference TPU kernel's
    input layout (the Hopper kernel reads the bool grid directly)."""
    C, G = occ_grid.shape[0], occ_grid.shape[1]
    bx, by, bz = OCC_BRICK
    o = occ_grid.reshape(C, G // bx, bx, G // by, by, G // bz, bz)
    o = o.permute(0, 1, 3, 5, 6, 4, 2)
    return o.reshape(-1, bx * by * bz).to(torch.bfloat16)


def _occ_lookup_cuda(xyz, dt, occ_grid, cfg: MarchConfig) -> torch.Tensor:
    C, G = cfg.cascades, cfg.grid_size
    if xyz.dtype != torch.float32 or dt.dtype != torch.float32:
        raise ValueError("xyz and dt must be float32")
    if xyz.shape[-1] != 3 or xyz.shape[:-1] != dt.shape:
        raise ValueError(f"xyz {tuple(xyz.shape)} and dt "
                         f"{tuple(dt.shape)} do not match")
    if occ_grid.dtype != torch.bool or occ_grid.shape != (C, G, G, G):
        raise ValueError(f"occ_grid must be ({C}, {G}, {G}, {G}) bool")
    if not (xyz.device == dt.device == occ_grid.device):
        raise ValueError("xyz, dt and occ_grid must share a CUDA device")
    if not (xyz.is_contiguous() and dt.is_contiguous()
            and occ_grid.is_contiguous()):
        raise ValueError("xyz, dt and occ_grid must be contiguous")
    out = torch.empty(dt.shape, dtype=torch.bool, device=dt.device)
    with torch.cuda.device(dt.device):
        kernels.launch(
            "occ_lookup", xyz.data_ptr(), dt.data_ptr(),
            occ_grid.data_ptr(), out.data_ptr(), dt.numel(), C, G,
            float(cfg.scale), torch.cuda.current_stream().cuda_stream,
        )
    return out


def occupancy_lookup_bricks(
    xyz: torch.Tensor,
    dt: torch.Tensor,
    occ_grid: torch.Tensor,
    cfg: MarchConfig,
) -> torch.Tensor:
    """(N, K) candidate occupancy, exactly `occupancy_lookup`'s.

    The reference's TPU strategy (4x4x8-brick run dedup with a Pallas
    extract kernel) exists because the TPU lacks a fast gather; here the
    CUDA kernel reads each candidate's cell directly, on any shape."""
    if xyz.is_cuda:
        return _occ_lookup_cuda(xyz, dt, occ_grid, cfg)
    if xyz.device.type != "cpu":
        raise ValueError(f"no occupancy lookup for device {xyz.device}")
    return occupancy_lookup(xyz, dt, occ_grid, cfg)


def _compact_flat_from_keep(t, dt, keep, cfg: MarchConfig,
                            budget_per_ray: int):
    """Compact kept lattice candidates into the flat (static-CSR) buffer of
    B = N * budget_per_ray slots: per-ray caps (front truncation under
    the global budget, at least 1 sample for a ray that hits), rays
    contiguous in ray order.

    Returns (march_dict, flat_sel); flat_sel (B,) is each slot's index
    into the flattened (N*K,) candidate array."""
    N, K = keep.shape
    dev = keep.device
    B = N * budget_per_ray
    within = torch.cumsum(keep.to(torch.int32), dim=1, dtype=torch.int32)
    n_r = within[:, -1].clamp_max(cfg.samples_per_ray)
    total = n_r.sum(dtype=torch.int32)
    # float ratio, as the reference (no int overflow of n_r * B)
    ratio = _f32(float(B)).to(dev) / total.clamp_min(1).to(torch.float32)
    floor_cap = torch.floor(n_r.to(torch.float32) * ratio).to(torch.int32)
    cap = torch.where(
        total <= B, n_r, torch.minimum(n_r, floor_cap.clamp_min(1))
    )
    bounds = torch.cumsum(cap, dim=0, dtype=torch.int32)
    offsets = bounds - cap
    total_c = bounds[-1].clamp_max(B)

    j = torch.arange(B, dtype=torch.int32, device=dev)
    # ray id per slot: +1 at each ray's start offset, cumsum - 1; offsets
    # past the buffer spill into slot B (dropped by the [:B] view)
    starts = torch.zeros(B + 1, dtype=torch.int32, device=dev)
    starts.index_add_(0, offsets.clamp_max(B).long(),
                      torch.ones_like(offsets))
    ray_id = (torch.cumsum(starts[:B], 0, dtype=torch.int32) - 1).clamp(
        0, N - 1)
    valid = j < total_c
    rid = ray_id.long()
    within_idx = j - offsets[rid]

    # per ray, candidate index and t of its i-th kept sample, i < Sc: the
    # kept candidates scatter to their rank (unique per ray); the rest go
    # to a discard column. Equals the reference's per-ray sort on every
    # slot that is read for a valid sample.
    Sc = min(K, cfg.samples_per_ray)
    rank = (within - 1).long()
    col = torch.where(keep & (rank < Sc), rank, Sc)
    k_sorted = torch.full((N, Sc + 1), K - 1, dtype=torch.int32, device=dev)
    k_sorted.scatter_(
        1, col, torch.arange(K, dtype=torch.int32, device=dev).expand(N, K)
    )
    t_sorted = torch.zeros((N, Sc + 1), dtype=t.dtype, device=dev)
    t_sorted.scatter_(1, col, t)
    wi = within_idx.clamp_max(Sc - 1).long()
    slot = rid * Sc + wi
    k_sel = k_sorted[:, :Sc].reshape(-1)[slot].clamp_max(K - 1)

    flat = ray_id * K + k_sel
    ts = torch.where(valid, t_sorted[:, :Sc].reshape(-1)[slot], 0.0)
    if cfg.exp_step_factor == 0.0:
        # constant-dt lattice: no per-sample step-size gather needed
        deltas = torch.where(valid, _f32(cfg.dt_min).to(dev), 0.0)
    else:
        deltas = torch.where(valid, dt.reshape(-1)[flat.long()], 0.0)
    return {
        "ts": ts,
        "deltas": deltas,
        "ray_id": ray_id,
        "valid": valid,
        "offsets": offsets,
        "cap": cap,
        "n_samples": cap,
        "total": total_c,
    }, flat


def march_rays_test_flat(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    cursor: torch.Tensor,
    t2: torch.Tensor,
    occ_grid: torch.Tensor,
    cfg: MarchConfig,
    alive: torch.Tensor,
    k_block: int = 256,
    cap_per_ray: int = 64,
    budget_per_ray: int = 16,
) -> dict:
    """One test-time marching block into the flat (static-CSR) layout.

    From each alive ray's `cursor`, examine the next `k_block` lattice
    candidates; the kept samples of alive rays compact into one (N *
    budget_per_ray,) buffer (at most `cap_per_ray` per ray). The cursor
    advances past the last CONSUMED sample, so truncated rays resume at
    the next call.

    Returns the flat march dict (ts/deltas/ray_id/valid/offsets/cap/
    n_samples/total) plus new_cursor, kept and consumed, all (N,)."""
    N = rays_o.shape[0]
    K = k_block
    dev = rays_o.device
    k = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    t = sample_lattice(cursor[:, None], k, cfg)          # (N, K)
    dt = calc_dt(t, cfg)
    in_range = alive[:, None] & (cursor[:, None] >= 0) & (t < t2[:, None])
    xyz = fma32(t[..., None], rays_d[:, None, :], rays_o[:, None, :])
    keep = in_range & occupancy_lookup_bricks(xyz, dt, occ_grid, cfg)
    cfg_c = dataclasses.replace(cfg, samples_per_ray=cap_per_ray)
    m, flat_sel = _compact_flat_from_keep(t, dt, keep, cfg_c, budget_per_ray)
    B = N * budget_per_ray

    kept = keep.sum(dim=1, dtype=torch.int32)
    granted = m["cap"]
    offsets = m["offsets"]
    # under saturation the min-1 cap can push sum(cap) past B: advance by
    # what was CONSUMED (granted slots inside [0, total)), never granted
    consumed = (
        torch.minimum(offsets + granted, m["total"])
        - torch.minimum(offsets, m["total"])
    ).clamp_min(0)
    last_slot = (offsets + consumed - 1).clamp(0, B - 1)
    k_last = flat_sel[last_slot.long()] - torch.arange(
        N, dtype=torch.int32, device=dev) * K
    # truncated rays resume right after the last consumed sample; fully
    # consumed (or empty) windows advance past all K candidates
    next_idx = torch.where(consumed >= kept, K, k_last + 1)
    new_cursor = torch.minimum(sample_lattice(cursor, next_idx, cfg), t2)
    # every granted slot spilled past the buffer: retry the same window
    new_cursor = torch.where((consumed == 0) & (kept > 0), cursor,
                             new_cursor)
    new_cursor = torch.where(alive, new_cursor, cursor)
    return {**m, "new_cursor": new_cursor, "kept": kept,
            "consumed": torch.where(alive, consumed, 0)}


def _lattice_candidates(rays_o, rays_d, t1, t2, cfg: MarchConfig, noise):
    """Candidate generation: start t1 jittered by noise * dt(t1), the
    closed-form lattice, per-candidate dt and xyz, and the in-range mask.
    Returns (t, dt, xyz, in_range), all (N, K[, 3])."""
    K = cfg.k_candidates
    t1 = t1.to(torch.float32)
    if noise is not None:
        t1 = torch.where(t1 >= 0, fma32(calc_dt(t1, cfg), noise, t1), t1)
    k = torch.arange(K, dtype=torch.int32, device=t1.device)[None, :]
    t = sample_lattice(t1[:, None], k, cfg)
    dt = calc_dt(t, cfg)
    in_range = (t1[:, None] >= 0) & (t >= 0) & (t < t2[:, None])
    xyz = fma32(t[..., None], rays_d[:, None, :], rays_o[:, None, :])
    return t, dt, xyz, in_range


def march_rays_train_flat(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t1: torch.Tensor,
    t2: torch.Tensor,
    occ_grid: torch.Tensor,
    cfg: MarchConfig,
    noise: torch.Tensor | None = None,
    budget_per_ray: int = 64,
) -> dict:
    """Training-time march of one occupancy grid into the flat (static-CSR)
    buffer of B = N * budget_per_ray slots: each ray's occupied lattice
    candidates (at most cfg.samples_per_ray), front-truncated to
    floor(n_r * B / total) when they overflow the buffer, rays contiguous.
    Returns ts/deltas/ray_id/valid (B,), offsets/cap/n_samples (N,) and
    total."""
    t, dt, xyz, in_range = _lattice_candidates(
        rays_o, rays_d, t1, t2, cfg, noise
    )
    keep = in_range & occupancy_lookup_bricks(xyz, dt, occ_grid, cfg)
    m, _ = _compact_flat_from_keep(t, dt, keep, cfg, budget_per_ray)
    return m


def march_rays_union_flat(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t1: torch.Tensor,
    t2: torch.Tensor,
    occ_grids: torch.Tensor,
    cfg: MarchConfig,
    noise: torch.Tensor | None = None,
    budget_per_ray: int = 64,
    cap_scale: int = 1,
) -> tuple[dict, torch.Tensor]:
    """Training-time march against K occupancy grids at once (MoE union
    sampling): ONE march against the union grid with a shared start
    jitter, then each expert's membership of the compacted samples.

    The static budget B = N * budget_per_ray and the per-ray cap
    cap_scale * cfg.samples_per_ray apply to the union stream, with the
    reference's front-biased truncation. Returns (march_dict, member):
    the flat march dict over the union and member (K, B) bool."""
    t, dt, xyz, in_range = _lattice_candidates(
        rays_o, rays_d, t1, t2, cfg, noise
    )
    occ_union = occ_grids.any(dim=0).contiguous()
    keep = in_range & occupancy_lookup_bricks(xyz, dt, occ_union, cfg)
    cfg_u = dataclasses.replace(
        cfg, samples_per_ray=cfg.samples_per_ray * cap_scale
    )
    m, flat_sel = _compact_flat_from_keep(t, dt, keep, cfg_u, budget_per_ray)
    if cfg.exp_step_factor == 0.0:
        # constant-dt lattice: positions recomputed from the compacted ts
        sel_dt = torch.full_like(m["ts"], cfg.dt_min)
        rid = m["ray_id"].long()
        sel_xyz = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])
    else:
        sel_dt = dt.reshape(-1)[flat_sel.long()]
        sel_xyz = xyz.reshape(-1, 3)[flat_sel.long()]
    member = torch.stack([
        occupancy_lookup(sel_xyz, sel_dt, occ, cfg) for occ in occ_grids
    ]) & m["valid"][None, :]
    return m, member


def _compact_keep(t, dt, keep, S: int):
    """The first S kept candidates of each ray in dense (N, S) slots: slot
    s of ray r holds candidate searchsorted(cumsum(keep[r]), s + 1), the
    left side, clamped to K - 1. Returns (ts, deltas, valid, n_samples):
    ts and deltas (N, S) (zero on unused slots; not differentiated),
    valid (N, S) bool, n_samples (N,) int32."""
    N, K = keep.shape
    dev = keep.device
    within = torch.cumsum(keep.to(torch.int32), dim=1, dtype=torch.int32)
    targets = torch.arange(1, S + 1, dtype=torch.int32, device=dev)
    k_idx = torch.searchsorted(
        within, targets.expand(N, S).contiguous(), side="left"
    ).clamp_max(K - 1)
    n_samples = within[:, -1].clamp_max(S)
    valid = torch.arange(S, dtype=torch.int32, device=dev)[None, :] < (
        n_samples[:, None])
    ts = torch.where(valid, torch.gather(t, 1, k_idx), 0.0).detach()
    deltas = torch.where(valid, torch.gather(dt, 1, k_idx), 0.0).detach()
    return ts, deltas, valid, n_samples


def march_rays_train(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    t1: torch.Tensor,
    t2: torch.Tensor,
    occ_grid: torch.Tensor,
    cfg: MarchConfig,
    noise: torch.Tensor | None = None,
) -> dict:
    """Training-time march of one occupancy grid into the dense layout:
    each ray's first cfg.samples_per_ray occupied lattice candidates from
    its start t1 jittered by noise * dt(t1) (a ray with t1 < 0 misses).
    Returns ts, deltas (N, S) (zero on unused slots), valid (N, S) and
    n_samples (N,) int32."""
    t, dt, xyz, in_range = _lattice_candidates(
        rays_o, rays_d, t1, t2, cfg, noise
    )
    keep = in_range & occupancy_lookup_bricks(xyz, dt, occ_grid, cfg)
    ts, deltas, valid, n_samples = _compact_keep(
        t, dt, keep, cfg.samples_per_ray)
    return {"ts": ts, "deltas": deltas, "valid": valid,
            "n_samples": n_samples}


def march_rays_test_block(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    cursor: torch.Tensor,
    t2: torch.Tensor,
    occ_grid: torch.Tensor,
    cfg: MarchConfig,
    n_samples: int,
    k_block: int = 512,
) -> dict:
    """One test-time march block of the dense layout (twin of
    vren.raymarching_test): from each ray's `cursor`, the next `k_block`
    lattice candidates, the first `n_samples` occupied ones compacted.
    The cursor resumes right after the n_samples-th kept candidate, or
    past the block when fewer were kept, clamped to t2.

    Returns ts, deltas, valid (N, n_samples), n_eff (N,) int32 and
    new_cursor (N,)."""
    N = rays_o.shape[0]
    S, K = n_samples, k_block
    dev = rays_o.device
    k = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    t = sample_lattice(cursor[:, None], k, cfg)          # (N, K)
    dt = calc_dt(t, cfg)
    in_range = (cursor[:, None] >= 0) & (t < t2[:, None])
    xyz = fma32(t[..., None], rays_d[:, None, :], rays_o[:, None, :])
    keep = in_range & occupancy_lookup_bricks(xyz, dt, occ_grid, cfg)
    ts, deltas, valid, got = _compact_keep(t, dt, keep, S)
    within = torch.cumsum(keep.to(torch.int32), dim=1, dtype=torch.int32)
    took_all = within[:, -1] >= S
    # the S-th kept candidate: the first index where the count reaches S
    idx_s = ((within == S) & keep).to(torch.uint8).argmax(dim=1)
    next_idx = torch.where(took_all, idx_s + 1, K)
    new_cursor = sample_lattice(cursor, next_idx, cfg)
    new_cursor = torch.where(
        torch.minimum(new_cursor, t2) == new_cursor, new_cursor, t2)
    return {"ts": ts, "deltas": deltas, "valid": valid, "n_eff": got,
            "new_cursor": new_cursor}
