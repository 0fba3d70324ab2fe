"""Slab-layout hash-grid encode (twin of radnerf_tpu/ops/hashgrid_slab.py).

Addressing (per level; u32 math; C = lanes, R = T // C rows):
  DENSE class ((res+1)^3 <= T; C = max(res+1, 128) or res+1):
      q = y + (res+1) * z          m = x            -- injective, exact
  HASHED class (C = min(1024, T // 64)):
      q = (y + psi_l(z) + (x >> log2 C)) mod (R-1)  m = x mod C
  entry = q * C + m; the corners (x, x+1) x (y, y+1) of z-corner zc are
  entries (q + yr) * C + m + xr with q at psi_l(z + zc).

A different spatial hash than tcnn's; tables are tied to the family.
The one corner per level whose entry lands on T reads entry T - 1 in the
forward, and its gradient is dropped (the reference's spare slab row).

The forwards are plain gathers ('plain': f32 weight products in the
order w_z w_y w_x, summed corner by corner; 'dedup': the dedup forward
over this addressing, ops/hashgrid_dedup.py). The backward is one pair
entry per (sample, level, z-corner, y-corner) covering entries (k, k+1),
added by the `slab_table_grad` kernel (ops/hashgrid_window.py), the exact
f32 gradient (the reference's pack_f16=False). bfloat16 compute only.
"""

from __future__ import annotations

import dataclasses

import torch

from .fma import fma32
from .hashgrid import _M32, HashGridConfig, _cm_out, _geometry, _mul32
from .hashgrid import table_grad_encode
from .hashgrid_window import hashgrid_table_grad_window_pair

_PSI_MUL1 = 2654435761
_PSI_MUL2 = 805459861
_PSI_SALT = 0x9E3779B9


@dataclasses.dataclass(frozen=True)
class _LevelAddr:
    """Static addressing constants of one level."""

    level: int
    res: int          # corner coords span [0, res]
    dense: bool
    C: int            # lanes
    R: int            # rows (T // C)
    log2C: int        # only used when C is a power of two (hashed class)


def level_addrs(cfg: HashGridConfig) -> list[_LevelAddr]:
    T = cfg.table_size
    C_h = min(1024, max(128, T // 64))
    out = []
    for lvl, res in enumerate(cfg.level_resolutions()):
        res = int(res)
        C = next((c for c in (max(res + 1, 128), res + 1)
                  if c * (res + 1) ** 2 <= T), None)
        if C is not None:
            out.append(_LevelAddr(lvl, res, True, C, T // C, 0))
        else:
            out.append(_LevelAddr(lvl, res, False, C_h, T // C_h,
                                  int(C_h).bit_length() - 1))
    return out


def _psi(z: torch.Tensor, level: int) -> torch.Tensor:
    """Per-level multiply-xor scramble of the z corner coordinate: u32
    arithmetic in int64, masked to 32 bits after every step."""
    s = (_mul32(z.to(torch.int64) & _M32, _PSI_MUL1)
         + ((_PSI_SALT * (level + 1)) & _M32)) & _M32
    s = s ^ (s >> 16)
    s = _mul32(s, _PSI_MUL2)
    return s ^ (s >> 13)


def _qm(a: _LevelAddr, xi, yi, zi, zc: int):
    """Row q and lane m (int64, u32 values) of the slab base of
    z-corner zc."""
    xu = xi.to(torch.int64) & _M32
    yu = yi.to(torch.int64) & _M32
    zu = (zi.to(torch.int64) + zc) & _M32
    if a.dense:
        return (yu + (a.res + 1) * zu) & _M32, xu
    q = ((yu + _psi(zu, a.level) + (xu >> a.log2C)) & _M32) % (a.R - 1)
    return q, xu & (a.C - 1)


def _pad128(x: torch.Tensor):
    """x padded to a multiple of 128 rows with copies of its last row (the
    reference's stream length)."""
    N = x.shape[0]
    pad = (-N) % 128
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, 3)])
    return x, N


def hashgrid_encode_slab_fwd_impl(table: torch.Tensor, x: torch.Tensor,
                                  cfg: HashGridConfig) -> torch.Tensor:
    """Non-differentiable slab forward: (N, L*2) bf16 features. Per
    corner: the bf16 value times the f32 weight w_z w_y w_x, added to the
    f32 sum with one rounding (the jitted reference contracts
    acc + w * v into a fused multiply-add); the sum rounded to bf16."""
    L, T, _ = table.shape
    t = table.to(torch.bfloat16).to(torch.float32).reshape(-1, 2)
    xi, yi, zi, frac = _geometry(x, cfg, range(L))
    out0, out1 = [], []
    for a in level_addrs(cfg):
        fx, fy, fz = frac[a.level, 0], frac[a.level, 1], frac[a.level, 2]
        acc0 = torch.zeros_like(fx)
        acc1 = torch.zeros_like(fx)
        for zc in (0, 1):
            wz = fz if zc else 1.0 - fz
            q, m = _qm(a, xi[a.level], yi[a.level], zi[a.level], zc)
            for yr in (0, 1):
                wy = fy if yr else 1.0 - fy
                base = (q + yr) * a.C + m
                for xr in (0, 1):
                    wx = fx if xr else 1.0 - fx
                    f = t[a.level * T + torch.clamp(base + xr, max=T - 1)]
                    w = wz * wy * wx
                    acc0 = fma32(w, f[:, 0], acc0)
                    acc1 = fma32(w, f[:, 1], acc1)
        out0.append(acc0)
        out1.append(acc1)
    return _cm_out(torch.stack(out0).to(torch.bfloat16),
                   torch.stack(out1).to(torch.bfloat16))


def _bwd_streams(x: torch.Tensor, g: torch.Tensor, cfg: HashGridConfig):
    """The pair stream of the backward: key (L, 4N') int32 and the planes
    (f0 x-even, f0 x-odd, f1 x-even, f1 x-odd), each (L, 4N') f32, with N'
    = N padded to 128 (padding rows carry zero gradients); entry
    (2 zc + yr) N' + i of sample i."""
    L = cfg.n_levels
    xp, N = _pad128(x)
    Np = xp.shape[0]
    gt = g.T.reshape(L, 2, N).to(torch.float32)
    if Np != N:
        gt = torch.nn.functional.pad(gt, (0, Np - N))
    g0, g1 = gt[:, 0], gt[:, 1]
    xi, yi, zi, frac = _geometry(xp, cfg, range(L))
    keys = []
    vals = [[] for _ in range(4)]
    for a in level_addrs(cfg):
        fx, fy, fz = frac[a.level, 0], frac[a.level, 1], frac[a.level, 2]
        ks, vs = [], [[] for _ in range(4)]
        for zc in (0, 1):
            q, m = _qm(a, xi[a.level], yi[a.level], zi[a.level], zc)
            wz = fz if zc else 1.0 - fz
            for yr in (0, 1):
                wy = fy if yr else 1.0 - fy
                ks.append(((q + yr) * a.C + m).to(torch.int32))
                we = wz * wy * (1.0 - fx)
                wo = wz * wy * fx
                for vi, v in enumerate((we * g0[a.level], wo * g0[a.level],
                                        we * g1[a.level], wo * g1[a.level])):
                    vs[vi].append(v)
        keys.append(torch.cat(ks))
        for vi in range(4):
            vals[vi].append(torch.cat(vs[vi]))
    return torch.stack(keys), [torch.stack(v) for v in vals]


def hashgrid_table_grad_slab(x: torch.Tensor, g: torch.Tensor,
                             cfg: HashGridConfig) -> torch.Tensor:
    """dL/dtable of the slab encode: x (N, 3), g (N, L*2) f32 -> (L, T, 2)
    f32, through the slab_table_grad kernel."""
    key, (v0e, v0o, v1e, v1o) = _bwd_streams(x, g, cfg)
    return hashgrid_table_grad_window_pair(key, v0e, v0o, v1e, v1o,
                                           cfg.table_size)


def hashgrid_encode_slab(table: torch.Tensor, x: torch.Tensor,
                         cfg: HashGridConfig, compute_dtype=torch.bfloat16,
                         fw_mode: str = "dedup") -> torch.Tensor:
    """The differentiable slab encode. fw_mode 'dedup' takes the dedup
    forward over the slab addressing, 'plain' the per-corner forward; both
    share the pair backward. bfloat16 only (encode_dispatch falls back to
    'dedup' for other dtypes)."""
    if compute_dtype != torch.bfloat16:
        raise ValueError("hashgrid_encode_slab is bfloat16-only")
    if fw_mode not in ("dedup", "plain"):
        raise ValueError(f"unknown fw_mode {fw_mode!r}")
    if fw_mode == "dedup":
        from .hashgrid_dedup import hashgrid_encode_dedup_fwd_impl

        def fwd(t, v):
            return hashgrid_encode_dedup_fwd_impl(t, v, cfg, torch.bfloat16,
                                                  addr="slab")
    else:
        def fwd(t, v):
            return hashgrid_encode_slab_fwd_impl(t, v, cfg)
    return table_grad_encode(table, x, fwd,
                             lambda v, g: hashgrid_table_grad_slab(v, g, cfg))
