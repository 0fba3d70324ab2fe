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
plain PyTorch twin, on CPU tensors. The backward (table gradient) comes
with the training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from .fma import fma32
from .hashgrid import HashGridConfig, _cm_out

LANES = 128
PATCH = 4           # owned cells per patch axis
PLANE = 5           # stored lattice points per patch axis (halo = 1)

_MIX1 = 2654435761
_MIX2 = 805459861
_MIX3 = 3674653429
_SALT = 0x9E3779B9
_FMIX = 0x85EBCA6B
_M32 = 0xFFFFFFFF

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


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) without int64 overflow:
    the constant is split into 16-bit halves (each product < 2^48)."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


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


def _geometry(x: torch.Tensor, cfg: HashGridConfig, levels: list[int]):
    """floor coords (3 x (G, N) int32) + frac ((G, 3, N) f32), with
    pos = fma(x, scale, 0.5) as in the jitted reference."""
    scales = torch.as_tensor(cfg.level_scales()[levels], device=x.device)
    pos = fma32(x.T[None, :, :], scales[:, None, None], 0.5)
    pos_i = torch.floor(pos)
    frac = pos - pos_i
    pos_i = pos_i.to(torch.int32)
    return pos_i[:, 0], pos_i[:, 1], pos_i[:, 2], frac


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


def _encode_plain(
    packed: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """Plain PyTorch twin of the CUDA kernel: per (sample, level), read the
    8 corner words of the sample's row and sum weight x bf16 value in
    float32 (corner order, separate roundings), then round to bf16."""
    L = cfg.n_levels
    R = cfg.table_size // LANES
    words = packed.reshape(-1)
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
            lo, hi = _unpack_bf16(words[base + off])
            a0 = a0 + wc * lo.to(torch.float32)
            a1 = a1 + wc * hi.to(torch.float32)
        out0.append(a0)
        out1.append(a1)
    return _cm_out(torch.stack(out0), torch.stack(out1)).to(torch.bfloat16)


def _level_params(cfg: HashGridConfig):
    addrs = brick3_addrs(cfg)
    scales = np.ascontiguousarray(cfg.level_scales(), np.float32)
    nps = np.asarray([a.np_ for a in addrs], np.int32)
    dense = np.asarray([int(a.dense) for a in addrs], np.int32)
    return scales, nps, dense


def _encode_cuda(
    packed: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    L = cfg.n_levels
    R = cfg.table_size // LANES
    if packed.dtype != torch.int32 or packed.shape != (L * R, LANES):
        raise ValueError(f"packed table must be ({L * R}, {LANES}) int32, "
                         f"got {tuple(packed.shape)} {packed.dtype}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be (N, 3) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not (packed.is_cuda and x.device == packed.device):
        raise ValueError("packed table and x must be on the same CUDA "
                         "device")
    if not (packed.is_contiguous() and x.is_contiguous()):
        raise ValueError("packed table and x must be contiguous")
    if not 1 <= L <= 32:
        raise ValueError("the kernel takes 1 to 32 levels")
    N = x.shape[0]
    out = torch.empty((N, 2 * L), dtype=torch.bfloat16, device=x.device)
    scales, nps, dense = _level_params(cfg)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.launch(
            "brick3_encode_fwd", packed.data_ptr(), x.data_ptr(),
            out.data_ptr(), N, L, R, scales.ctypes.data, nps.ctypes.data,
            dense.ctypes.data, stream,
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
    kernel serves both. `packed` (from pack_brick3_table) skips packing
    the table again when the caller encodes many batches."""
    if fw_mode not in ("runs", "plain"):
        raise ValueError(f"unknown fw_mode {fw_mode!r}")
    if packed is None:
        packed = pack_brick3_table(table)
    if x.is_cuda:
        return _encode_cuda(packed, x, cfg)
    if x.device.type != "cpu":
        raise ValueError(f"no brick3 encode for device {x.device}")
    return _encode_plain(packed, x, cfg)
