"""Cube-brick (brick3) hash-grid encode, forward (twin of the forward half
of radnerf_tpu/ops/hashgrid_brick3.py).

Layout: the (L, T, 2) f32 table is packed to bf16x2 words (feature 0 in
the low half) and viewed as rows of 128 words. Row r of level l holds a
5x5x5 cube of lattice points, lane(x, y, z) = (x - 4px) + 5 (y - 4py) +
25 (z - 4pz), so all 8 trilinear corners of a cell live in one row.
Rows are addressed per level:

  DENSE  ((res//4 + 1)^3 <= R):  row = px + np * (py + np * pz)
  HASHED:                        row = mix(px, py, pz, level) & (R - 1)

with R = T / 128 rows per level. The table layout and the hash are the
reference's bit for bit, so a brick3 table trained by either package
decodes the same in the other.

`hashgrid_encode_brick3_fwd_impl` launches the CUDA kernel
`csrc/brick3_encode_fwd.cu` on CUDA tensors and runs `_encode_plain`, its
plain PyTorch twin, on CPU tensors. Both read either the packed words or
the (L, T, 2) f32 table itself, rounding each corner value to bf16 as the
pack would: the training step encodes once per table and reads it as it
is, while the render and the grid update pack once for many encodes.
`hashgrid_table_grad_brick3` (the backward: dL/dtable) launches
`csrc/brick3_table_grad.cu` on CUDA tensors and runs `_table_grad_plain`
on CPU tensors. `hashgrid_encode_brick3` is the differentiable encode:
its backward is the table gradient.

The backward is the exact f32 gradient (the reference's `exact=True`
path). The reference's default backward quantizes the fractions to 10
bits and g to bf16 before its TPU sort and runs bf16 matmul operands;
none of that exists here.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import kernels
from .hashgrid import (
    _M32, HashGridConfig, _cm_out, _geometry, _mul32, table_grad_encode,
)

LANES = 128
PATCH = 4           # owned cells per patch axis
PLANE = 5           # stored lattice points per patch axis (halo = 1)

_MIX1 = 2654435761
_MIX2 = 805459861
_MIX3 = 3674653429
_SALT = 0x9E3779B9
_FMIX = 0x85EBCA6B

# corner lane offsets, (dz, dy, dx)-minor order: off = dx + 5 dy + 25 dz
_OFFS3 = tuple(
    dx + PLANE * dy + PLANE * PLANE * dz
    for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)
)


@dataclasses.dataclass(frozen=True)
class _Brick3Addr:
    level: int
    res: int
    dense: bool
    np_: int           # patches along each axis (dense class)
    rows: int


def brick3_addrs(cfg: HashGridConfig) -> list[_Brick3Addr]:
    if cfg.table_size % LANES:
        raise ValueError("brick3 needs a table size divisible by 128")
    R = cfg.table_size // LANES
    out = []
    for lvl, res in enumerate(cfg.level_resolutions()):
        res = int(res)
        np_ = res // PATCH + 1
        need = np_ ** 3
        if need <= R:
            out.append(_Brick3Addr(lvl, res, True, np_, need))
        else:
            out.append(_Brick3Addr(lvl, res, False, np_, R))
    return out


def _brick3_row(a: _Brick3Addr, px, py, pz, R: int) -> torch.Tensor:
    """Table row of cube patch (px, py, pz), as int64 in [0, R).

    u32 arithmetic done in int64 and masked to 32 bits after every step.
    Dense rows are masked with R - 1 too: a no-op for positions in
    [0, 1]^3 (rows < np^3 <= R), and it keeps any input in bounds."""
    px, py, pz = (v.to(torch.int64) & _M32 for v in (px, py, pz))
    if a.dense:
        return (px + a.np_ * (py + a.np_ * pz)) & (R - 1)
    h = _mul32(px, _MIX1) ^ _mul32(py, _MIX2) ^ _mul32(pz, _MIX3)
    h = (h + ((_SALT * (a.level + 1)) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX)
    h = h ^ (h >> 13)
    return h & (R - 1)


def _patch_lane3(xi, yi, zi):
    """Patch coords + base lane of integer base coords."""
    px = torch.div(xi, PATCH, rounding_mode="floor")
    py = torch.div(yi, PATCH, rounding_mode="floor")
    pz = torch.div(zi, PATCH, rounding_mode="floor")
    lane0 = (
        (xi - PATCH * px)
        + PLANE * (yi - PATCH * py)
        + PLANE * PLANE * (zi - PATCH * pz)
    )
    return px, py, pz, lane0


def _corner_weights(frac_l):
    """The 8 trilinear corner weights ((N,) f32 each) in _OFFS3 order."""
    fx, fy, fz = frac_l[0], frac_l[1], frac_l[2]
    wx = (1.0 - fx, fx)
    wy = (1.0 - fy, fy)
    wz = (1.0 - fz, fz)
    return tuple(
        wx[dx] * wy[dy] * wz[dz]
        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)
    )


def _unpack_bf16(g: torch.Tensor):
    """Packed int32 words -> (feature 0, feature 1) as bf16 tensors: the
    low and high 16 bits are the two bf16 bit patterns."""
    lo = (g << 16).view(torch.float32)
    hi = (g & -65536).view(torch.float32)
    return lo.to(torch.bfloat16), hi.to(torch.bfloat16)


def pack_brick3_table(table: torch.Tensor) -> torch.Tensor:
    """(L, T, 2) f32 table -> (L * T / 128, 128) int32 rows of bf16x2
    words (feature 0 in the low half, little-endian)."""
    L, T, F = table.shape
    if F != 2:
        raise ValueError("brick3 tables have 2 features")
    words = table.to(torch.bfloat16).contiguous().view(torch.int32)
    return words.reshape(L * T // LANES, LANES)


def hashgrid_encode_brick3_ref(
    table: torch.Tensor,
    x: torch.Tensor,
    cfg: HashGridConfig,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Golden path with the same addressing: one scalar gather per corner
    from the unpacked table, in `compute_dtype`. Returns (N, L*2)."""
    L, T, F = table.shape
    R = T // LANES
    t0 = table[..., 0].to(compute_dtype)
    t1 = table[..., 1].to(compute_dtype)
    xi, yi, zi, frac = _geometry(x, cfg, list(range(L)))
    out0, out1 = [], []
    for a in brick3_addrs(cfg):
        px, py, pz, lane0 = _patch_lane3(
            xi[a.level], yi[a.level], zi[a.level]
        )
        base = _brick3_row(a, px, py, pz, R) * LANES + lane0
        a0 = torch.zeros_like(frac[a.level, 2], dtype=compute_dtype)
        a1 = torch.zeros_like(a0)
        for wc, off in zip(_corner_weights(frac[a.level]), _OFFS3):
            w = wc.to(compute_dtype)
            a0 = a0 + w * t0[a.level][base + off]
            a1 = a1 + w * t1[a.level][base + off]
        out0.append(a0)
        out1.append(a1)
    return _cm_out(torch.stack(out0), torch.stack(out1))


def _corner_values(src: torch.Tensor, e: torch.Tensor):
    """(feature 0, feature 1) of flat table entries e as bf16 tensors, from
    packed words (pack_brick3_table) or from the (L, T, 2) f32 table (each
    value rounded to bf16, as the pack rounds it)."""
    if src.dtype == torch.int32:
        return _unpack_bf16(src.reshape(-1)[e])
    v = src.reshape(-1, 2)[e].to(torch.bfloat16)
    return v[..., 0], v[..., 1]


def _encode_plain(
    src: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """Plain PyTorch twin of the CUDA kernel: per (sample, level), read the
    8 corners of the sample's row from `src` (packed words or the f32
    table) and sum weight x bf16 value in float32 (corner order, separate
    roundings), then round to bf16."""
    L = cfg.n_levels
    R = cfg.table_size // LANES
    xi, yi, zi, frac = _geometry(x, cfg, list(range(L)))
    out0, out1 = [], []
    for a in brick3_addrs(cfg):
        px, py, pz, lane0 = _patch_lane3(
            xi[a.level], yi[a.level], zi[a.level]
        )
        base = (a.level * R + _brick3_row(a, px, py, pz, R)) * LANES + lane0
        a0 = torch.zeros_like(frac[a.level, 0])
        a1 = torch.zeros_like(a0)
        for wc, off in zip(_corner_weights(frac[a.level]), _OFFS3):
            lo, hi = _corner_values(src, base + off)
            a0 = a0 + wc * lo.to(torch.float32)
            a1 = a1 + wc * hi.to(torch.float32)
        out0.append(a0)
        out1.append(a1)
    return _cm_out(torch.stack(out0), torch.stack(out1)).to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class _LevelParams:
    """The kernels' per-level arrays (read-only) and their addresses, the
    ctypes arguments of a launch."""
    scales: np.ndarray     # (L,) f32
    nps: np.ndarray        # (L,) i32, patches per axis
    dense: np.ndarray      # (L,) i32, 1 for a dense level
    ptrs: tuple


@functools.lru_cache(maxsize=None)
def _level_params(cfg: HashGridConfig) -> _LevelParams:
    """Built once per config (a frozen dataclass), so a launch builds no
    arrays; they live as long as the cache."""
    addrs = brick3_addrs(cfg)
    arrays = (
        np.ascontiguousarray(cfg.level_scales(), np.float32),
        np.asarray([a.np_ for a in addrs], np.int32),
        np.asarray([int(a.dense) for a in addrs], np.int32),
    )
    for a in arrays:
        a.flags.writeable = False
    return _LevelParams(*arrays, tuple(a.ctypes.data for a in arrays))


def _encode_cuda(
    src: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    L = cfg.n_levels
    R = cfg.table_size // LANES
    f32 = src.dtype == torch.float32
    want = ((L, R * LANES, 2), torch.float32) if f32 else (
        (L * R, LANES), torch.int32)
    if (tuple(src.shape), src.dtype) != want:
        raise ValueError(f"the table must be the (L, T, 2) float32 table or "
                         f"its ({L * R}, {LANES}) int32 packing, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be (N, 3) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not (src.is_cuda and x.device == src.device):
        raise ValueError("the table and x must be on the same CUDA device")
    if not (src.is_contiguous() and x.is_contiguous()):
        raise ValueError("the table and x must be contiguous")
    if not 1 <= L <= 32:
        raise ValueError("the kernel takes 1 to 32 levels")
    N = x.shape[0]
    out = torch.empty((N, 2 * L), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch(
            "brick3_encode_fwd", src.data_ptr(), int(f32), x.data_ptr(),
            out.data_ptr(), N, L, R, *_level_params(cfg).ptrs, stream,
        )
    return out


def hashgrid_encode_brick3_fwd_impl(
    table: torch.Tensor,
    x: torch.Tensor,
    cfg: HashGridConfig,
    fw_mode: str = "runs",
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """Cube-brick forward: (N, 3) positions in [0, 1]^3 -> (N, L*2) bf16
    features, level-major.

    `fw_mode` 'runs' and 'plain' are the reference's two TPU strategies
    for the same function (run-dedup vs one gather per row); on Hopper one
    kernel serves both. Without `packed` the kernel reads the f32 table as
    it is; `packed` (from pack_brick3_table, same result) is read instead
    when the caller packed once for many batches."""
    if fw_mode not in ("runs", "plain"):
        raise ValueError(f"unknown fw_mode {fw_mode!r}")
    src = table if packed is None else packed
    if x.is_cuda:
        return _encode_cuda(src, x, cfg)
    if x.device.type != "cpu":
        raise ValueError(f"no brick3 encode for device {x.device}")
    return _encode_plain(src, x, cfg)


def _corner_terms(x: torch.Tensor, cfg: HashGridConfig):
    """Flat (L*T) table entry and trilinear weight of every corner of
    every (sample, level): two (L, 8, N) tensors (int64, float32), with
    the forward's addressing and weights."""
    L = cfg.n_levels
    T = cfg.table_size
    R = T // LANES
    xi, yi, zi, frac = _geometry(x, cfg, list(range(L)))
    idx, wts = [], []
    for a in brick3_addrs(cfg):
        px, py, pz, lane0 = _patch_lane3(
            xi[a.level], yi[a.level], zi[a.level]
        )
        base = a.level * T + _brick3_row(a, px, py, pz, R) * LANES + lane0
        idx.append(torch.stack([base + off for off in _OFFS3]))
        wts.append(torch.stack(_corner_weights(frac[a.level])))
    return torch.stack(idx), torch.stack(wts)


def _table_grad_plain(x: torch.Tensor, g: torch.Tensor,
                      cfg: HashGridConfig) -> torch.Tensor:
    """Plain PyTorch twin of the table-gradient kernel: `index_add_` of
    w_corner * g_f (one f32 product each, as the kernel) over the 8
    corners of every (sample, level). Returns (L, T, 2) f32."""
    L, T = cfg.n_levels, cfg.table_size
    idx, w = _corner_terms(x, cfg)                       # (L, 8, N)
    gl = g.reshape(-1, L, 2).permute(1, 0, 2)            # (L, N, 2)
    vals = w[..., None] * gl[:, None]                    # (L, 8, N, 2)
    out = torch.zeros((L * T, 2), dtype=torch.float32, device=x.device)
    out.index_add_(0, idx.reshape(-1), vals.reshape(-1, 2))
    return out.reshape(L, T, 2)


def _table_grad_cuda(x: torch.Tensor, g: torch.Tensor,
                     cfg: HashGridConfig) -> torch.Tensor:
    L, T = cfg.n_levels, cfg.table_size
    R = T // LANES
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be (N, 3) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if g.shape != (x.shape[0], 2 * L):
        raise ValueError(f"g must be ({x.shape[0]}, {2 * L}), got "
                         f"{tuple(g.shape)}")
    if not (x.is_cuda and g.device == x.device):
        raise ValueError("x and g must be on the same CUDA device")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be contiguous")
    if not 1 <= L <= 32:
        raise ValueError("the kernel takes 1 to 32 levels")
    out = torch.zeros((L, T, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch(
            "brick3_table_grad", x.data_ptr(), g.data_ptr(),
            out.data_ptr(), x.shape[0], L, R, *_level_params(cfg).ptrs,
            stream,
        )
    return out


def hashgrid_table_grad_brick3(
    x: torch.Tensor, g: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """dL/dtable of the brick3 encode: x (N, 3) positions in [0, 1]^3, g
    (N, L*2) float32 gradient of its output -> (L, T, 2) float32."""
    if g.dtype != torch.float32:
        raise ValueError(f"g must be float32, got {g.dtype}")
    if x.is_cuda:
        return _table_grad_cuda(x, g, cfg)
    if x.device.type != "cpu":
        raise ValueError(f"no brick3 table gradient for device {x.device}")
    return _table_grad_plain(x, g, cfg)


def hashgrid_encode_brick3(
    table: torch.Tensor,
    x: torch.Tensor,
    cfg: HashGridConfig,
    fw_mode: str = "runs",
    packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """Differentiable brick3 encode: the forward of
    `hashgrid_encode_brick3_fwd_impl`, the backward
    `hashgrid_table_grad_brick3`. No gradient reaches x (the reference's
    ray-marcher position gradients are never consumed)."""
    return table_grad_encode(
        table, x,
        lambda t, v: hashgrid_encode_brick3_fwd_impl(t, v, cfg, fw_mode,
                                                     packed=packed),
        lambda v, g: hashgrid_table_grad_brick3(v, g, cfg))
