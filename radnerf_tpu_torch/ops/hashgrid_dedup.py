"""The 'dedup' tcnn-hash encode (twin of radnerf_tpu/ops/hashgrid_dedup.py).

The reference merges ray-ordered samples that share a voxel before its
gathers, because the TPU's gather issue rate is its limit. The merge is
exact by construction (only identical voxels merge; a block whose runs
overflow the level's cap falls back to the full gather), so the function
is the plain per-corner gather. On the card the port computes it that
way, one gather per corner. `level_caps` and `_group_levels` are kept so
that the signatures match.

The backward is the tcnn scatter kernel (`hashgrid_table_grad_window`)
for both of the reference's `grad_impl` values: 'dedup' reduces the
per-sample terms onto the runs before scattering, which changes only the
order of the same f32 sums.
"""

from __future__ import annotations

import math

import torch

from .hashgrid import (
    HashGridConfig, _encode_rows, _geometry, _trilinear_weights,
    hashgrid_encode, hashgrid_indices_cm, table_grad_encode,
)
from .hashgrid_slab import _qm, level_addrs
from .hashgrid_window import hashgrid_table_grad_window

BLOCK = 256         # W: samples per dedup block
_DT_REF = math.sqrt(3.0) / 1024.0   # reference dt_min (raymarching.cu:11)


def level_caps(cfg: HashGridConfig, block: int = BLOCK,
               dt_ref: float = _DT_REF) -> tuple[int, ...]:
    """The reference's static per-level unique-voxel caps U_l of a W-sample
    block (U = W: no dedup for that level)."""
    caps = []
    for res in cfg.level_resolutions():
        u = int(block * float(res) * math.sqrt(3.0) * dt_ref) + 16
        u = ((u + 7) // 8) * 8
        caps.append(block if u >= 0.9 * block else u)
    return tuple(caps)


def _group_levels(caps: tuple[int, ...], block: int):
    """Consecutive levels grouped by cap, and the levels with cap == block
    (the reference's plain-gather levels)."""
    groups: list[tuple[list[int], int]] = []
    plain: list[int] = []
    for lvl, u in enumerate(caps):
        if u >= block:
            plain.append(lvl)
        elif groups and groups[-1][1] == u:
            groups[-1][0].append(lvl)
        else:
            groups.append(([lvl], u))
    return groups, plain


def _slab_rows(x: torch.Tensor, cfg: HashGridConfig):
    """Flat (L*T) rows (L, 8, N) of the slab addressing in the dedup
    forward's corner order, with the boundary corner clamped to T - 1, and
    the fractions (L, 3, N)."""
    T = cfg.table_size
    xi, yi, zi, frac = _geometry(x, cfg, range(cfg.n_levels))
    rows = []
    for a in level_addrs(cfg):
        qm = [_qm(a, xi[a.level], yi[a.level], zi[a.level], zc)
              for zc in (0, 1)]
        rows.append(torch.stack([
            a.level * T + torch.clamp(
                (qm[c >> 2][0] + ((c >> 1) & 1)) * a.C + qm[c >> 2][1]
                + (c & 1), max=T - 1)
            for c in range(8)]))
    return torch.stack(rows), frac


def hashgrid_encode_dedup_fwd_impl(
    table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig,
    compute_dtype, block: int = BLOCK, caps: tuple[int, ...] | None = None,
    addr: str = "xor",
) -> torch.Tensor:
    """Non-differentiable forward: (N, L*2) features in `compute_dtype`.
    addr 'xor' is the tcnn hash (hashgrid_encode); 'slab' is the slab
    family's addressing, its weights rounded to `compute_dtype` before
    the products, as the reference's dedup forward does. `block` and
    `caps` shape the reference's merge only."""
    del block, caps
    if addr == "xor":
        return hashgrid_encode(table, x, cfg, compute_dtype)
    if addr != "slab":
        raise ValueError(f"unknown addr {addr!r}")
    rows, frac = _slab_rows(x, cfg)
    return _encode_rows(table, rows, _trilinear_weights(frac),
                        compute_dtype)


def hashgrid_table_grad_dedup(
    x: torch.Tensor, g: torch.Tensor, cfg: HashGridConfig,
    block: int = BLOCK, caps: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """dL/dtable of the 'xor' dedup forward: x (N, 3), g (N, L*2) f32 ->
    (L, T, 2) f32, through the tcnn scatter kernel."""
    del block, caps
    return hashgrid_table_grad_window(*hashgrid_indices_cm(x, cfg), g, cfg)


def hashgrid_encode_dedup(
    table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig,
    compute_dtype=torch.bfloat16, block: int = BLOCK,
    grad_impl: str = "window",
) -> torch.Tensor:
    """The dedup encode: forward hashgrid_encode_dedup_fwd_impl ('xor'),
    backward the tcnn scatter kernel (for grad_impl 'window' and
    'dedup' alike)."""
    if grad_impl not in ("window", "dedup"):
        raise ValueError(f"unknown grad_impl {grad_impl!r}")
    return table_grad_encode(
        table, x,
        lambda t, v: hashgrid_encode_dedup_fwd_impl(t, v, cfg,
                                                    compute_dtype, block),
        lambda v, g: hashgrid_table_grad_dedup(v, g, cfg, block))
