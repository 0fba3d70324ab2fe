"""Brick-layout hash-grid encode (twin of radnerf_tpu/ops/hashgrid_brick.py).

Layout: the (L, T, 2) table viewed as rows of 128 entries. Row r of
level l holds an 11 x 11 patch of lattice points of one z-slice,
lane(x, y) = (x - 10 px) + 11 (y - 10 py), so a cell's four xy-corners
sit at lanes lane0 + {0, 1, 11, 12} of one row, and a sample's 8 corners
are two rows: (px, py, z) and (px, py, z + 1). Rows are addressed per
level (R = T / 128):

  DENSE  (npx * npy * (res + 2) <= R):  row = px + npx * (py + npy * z)
  HASHED:                               row = mix(px, py, z, level) & (R-1)

A different layout than tcnn's; tables are tied to the family.

The forward is a plain gather of the four xy-corner entries of each of
the two rows. The backward is one entry per (sample, level, z-corner),
key row * 128 + lane0, carrying the four corners' w g products per
feature, added by the `brick_table_grad` kernel
(ops/stream_table_grad.py): the exact f32 gradient. The reference's
default rounds the products to f16 before its sort and runs bf16 matmul
operands (its pack_f16=False, exact=True path is the port's).
bfloat16 compute only.
"""

from __future__ import annotations

import dataclasses

import torch

from .hashgrid import (
    _M32, HashGridConfig, _cm_out, _geometry, _mul32, table_grad_encode,
)
from .stream_table_grad import stream_table_grad

LANES = 128
PATCH = 10          # owned cells per patch axis (x, y)
PLANE = 11          # stored lattice points per patch axis (halo = 1)

_MIX1 = 2654435761
_MIX2 = 805459861
_MIX3 = 3674653429
_SALT = 0x9E3779B9
_FMIX = 0x85EBCA6B

_OFFS = (0, 1, PLANE, PLANE + 1)     # the xy-corner lanes from lane0


@dataclasses.dataclass(frozen=True)
class _BrickAddr:
    """Static addressing constants of one level."""

    level: int
    res: int           # base lattice coords span [0, res]
    dense: bool
    npx: int           # patches along x (dense class)
    npy: int
    rows: int          # rows used (dense) or R (hashed)


def brick_addrs(cfg: HashGridConfig) -> list[_BrickAddr]:
    if cfg.table_size % LANES:
        raise ValueError("brick needs a table size divisible by 128")
    R = cfg.table_size // LANES
    out = []
    for lvl, res in enumerate(cfg.level_resolutions()):
        res = int(res)
        npx = res // PATCH + 1
        need = npx * npx * (res + 2)       # z corners span [0, res + 1]
        out.append(_BrickAddr(lvl, res, need <= R, npx, npx,
                              need if need <= R else R))
    return out


def _brick_row(a: _BrickAddr, px, py, zc, R: int) -> torch.Tensor:
    """Table row (int64, a u32 value) of patch (px, py) at z-slice zc: u32
    arithmetic in int64, masked to 32 bits after every step."""
    px, py, zc = (v.to(torch.int64) & _M32 for v in (px, py, zc))
    if a.dense:
        return (px + a.npx * (py + a.npy * zc)) & _M32
    h = _mul32(px, _MIX1) ^ _mul32(py, _MIX2) ^ _mul32(zc, _MIX3)
    h = (h + ((_SALT * (a.level + 1)) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX)
    h = h ^ (h >> 13)
    return h & (R - 1)


def _patch_lane(xi, yi):
    """Patch coords + base lane of integer base coords."""
    px = torch.div(xi, PATCH, rounding_mode="floor")
    py = torch.div(yi, PATCH, rounding_mode="floor")
    lane0 = (xi - PATCH * px) + PLANE * (yi - PATCH * py)
    return px, py, lane0


def _xy_weights(frac_l):
    """The four xy-corner weights (4 x (N,) f32) in _OFFS order."""
    fx, fy = frac_l[0], frac_l[1]
    return ((1.0 - fx) * (1.0 - fy), fx * (1.0 - fy),
            (1.0 - fx) * fy, fx * fy)


def _level_terms(a: _BrickAddr, xi, yi, zi, frac, R: int):
    """Per z-corner of one level: the flat key row * 128 + lane0 (int64),
    the z weight and the four xy weights."""
    px, py, lane0 = _patch_lane(xi[a.level], yi[a.level])
    w4 = _xy_weights(frac[a.level])
    fz = frac[a.level, 2]
    for zc, wz in ((0, 1.0 - fz), (1, fz)):
        r = _brick_row(a, px, py, zi[a.level].to(torch.int64) + zc, R)
        yield r * LANES + lane0, wz, w4


def hashgrid_encode_brick_fwd_impl(table: torch.Tensor, x: torch.Tensor,
                                   cfg: HashGridConfig) -> torch.Tensor:
    """Non-differentiable brick forward: (N, L*2) bf16 features. Per
    z-row: the xy-weighted sum of its four bf16 entries in f32, times the
    z weight, added to the f32 sum; the sum rounded to bf16."""
    L, T, _ = table.shape
    R = T // LANES
    t = table.to(torch.bfloat16).to(torch.float32).reshape(-1, 2)
    xi, yi, zi, frac = _geometry(x, cfg, range(L))
    out0, out1 = [], []
    for a in brick_addrs(cfg):
        acc = torch.zeros((x.shape[0], 2), dtype=torch.float32,
                          device=x.device)
        for key, wz, w4 in _level_terms(a, xi, yi, zi, frac, R):
            s = None
            for wc, off in zip(w4, _OFFS):
                term = wc[:, None] * t[a.level * T + key + off]
                s = term if s is None else s + term
            acc = acc + wz[:, None] * s
        out0.append(acc[:, 0])
        out1.append(acc[:, 1])
    return _cm_out(torch.stack(out0).to(torch.bfloat16),
                   torch.stack(out1).to(torch.bfloat16))


def sorted_table_grad_brick(sk: torch.Tensor, vals,
                            table_size: int) -> torch.Tensor:
    """(L, T, 2) f32 gradient of a brick stream: sk (L, n) int32 keys
    row * 128 + lane0, vals 8 planes (L, n) f32, corner (+0, +1, +11, +12)
    x feature (0, 1); entry k adds vals[2c + f] to entry sk + off_c,
    feature f. Any order; the exact f32 sums (the reference's
    exact=True)."""
    return stream_table_grad("brick_table_grad", sk.to(torch.int32),
                             torch.stack(list(vals)).to(torch.float32),
                             table_size)


def _bwd_streams(x: torch.Tensor, g: torch.Tensor, cfg: HashGridConfig):
    """The backward's stream: key (L, 2N) int32 and 8 value planes (L, 2N)
    f32 (corner c, feature f at 2c + f); entry zc N + i of sample i."""
    L = cfg.n_levels
    N = x.shape[0]
    R = cfg.table_size // LANES
    gt = g.T.reshape(L, 2, N).to(torch.float32)
    xi, yi, zi, frac = _geometry(x, cfg, range(L))
    keys, vals = [], [[] for _ in range(8)]
    for a in brick_addrs(cfg):
        ks, vv = [], [[] for _ in range(8)]
        for key, wz, w4 in _level_terms(a, xi, yi, zi, frac, R):
            ks.append(key.to(torch.int32))
            for ci, wc in enumerate(w4):
                w = wz * wc
                vv[2 * ci].append(w * gt[a.level, 0])
                vv[2 * ci + 1].append(w * gt[a.level, 1])
        keys.append(torch.cat(ks))
        for i in range(8):
            vals[i].append(torch.cat(vv[i]))
    return torch.stack(keys), [torch.stack(v) for v in vals]


def hashgrid_table_grad_brick(x: torch.Tensor, g: torch.Tensor,
                              cfg: HashGridConfig) -> torch.Tensor:
    """dL/dtable of the brick encode: x (N, 3), g (N, L*2) f32 -> (L, T, 2)
    f32, through the brick_table_grad kernel."""
    key, vals = _bwd_streams(x, g, cfg)
    return sorted_table_grad_brick(key, vals, cfg.table_size)


def hashgrid_encode_brick(table: torch.Tensor, x: torch.Tensor,
                          cfg: HashGridConfig,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The differentiable brick encode. bfloat16 only (encode_dispatch
    falls back to 'dedup' for other dtypes)."""
    if compute_dtype != torch.bfloat16:
        raise ValueError("hashgrid_encode_brick is bfloat16-only")
    return table_grad_encode(
        table, x, lambda t, v: hashgrid_encode_brick_fwd_impl(t, v, cfg),
        lambda v, g: hashgrid_table_grad_brick(v, g, cfg))
