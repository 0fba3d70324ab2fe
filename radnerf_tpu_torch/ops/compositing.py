"""Resumable volume compositing on the flat sample layout (twin of the
test-time half of radnerf_tpu/ops/compositing.py).

Per-ray sums are segmented scans over the ray-contiguous sample buffer.
They never sum across a segment boundary: a global cumsum minus the
prefix at each segment start would cancel catastrophically in float32
over ~1e5 exp-activated samples.
"""

from __future__ import annotations

import torch


def _shift(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """a shifted down by d rows along dim 0 (first d rows = fill)."""
    head = torch.full_like(a[:d], fill)
    return torch.cat([head, a[:-d]], dim=0)


def _segmented_scan(v, seg_start, op, identity):
    """Inclusive scan with `op` that restarts at segment starts: log2(B)
    doubling passes (Hillis-Steele). v (B,) or (B, C)."""
    f = seg_start if v.dim() == 1 else seg_start[:, None]
    f = f.expand_as(v)
    out = v
    d = 1
    while d < v.shape[0]:
        out = torch.where(f, out, op(_shift(out, d, identity), out))
        f = f | _shift(f, d, False)
        d *= 2
    return out


def segmented_cumsum_scan(
    v: torch.Tensor, seg_start: torch.Tensor
) -> torch.Tensor:
    """Inclusive segmented cumsum by a doubling scan. v (B,) or (B, C)."""
    return _segmented_scan(v, seg_start, torch.add, 0.0)


_SEG_BLOCK = 256


def segmented_cumsum(v: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum that resets at segment starts.

    Two-level blocked formulation, as the reference: within each
    256-sample block a masked triangular matmul M[i, j] = (seg_pos_i <= j
    <= i) gives the block-local segmented sums; a short scan over the
    block totals carries a segment across blocks, onto each block's prefix
    before its first segment start. v (B,) or (B, C); seg_start (B,)."""
    B = v.shape[0]
    if B <= 2 * _SEG_BLOCK:
        return segmented_cumsum_scan(v, seg_start)
    W = _SEG_BLOCK
    pad = (-B) % W
    vc = v if v.dim() > 1 else v[:, None]
    C = vc.shape[1]
    sb = seg_start
    if pad:
        vc = torch.cat([vc, vc.new_zeros((pad, C))])
        sb = torch.cat([sb, sb.new_zeros(pad)])
    nb = vc.shape[0] // W
    vb = vc.reshape(nb, W, C)
    sb = sb.reshape(nb, W)

    idx = torch.arange(W, device=v.device).expand(nb, W)
    # position of each sample's segment start within the block (0 = carry)
    seg_pos = torch.cummax(torch.where(sb, idx, 0), dim=1).values
    i_ = idx[:, :, None]
    j_ = idx[:, None, :]
    mask = ((j_ >= seg_pos[:, :, None]) & (j_ <= i_)).to(v.dtype)
    within = torch.bmm(mask, vb)                          # (nb, W, C)

    # carry over block totals (a segment can span blocks)
    carry_incl = segmented_cumsum_scan(within[:, -1, :], sb.any(dim=1))
    carry_in = torch.cat([carry_incl.new_zeros((1, C)), carry_incl[:-1]])
    first = torch.where(sb, idx, W).amin(dim=1)           # (nb,)
    out = within + torch.where(
        (idx < first[:, None])[:, :, None], carry_in[:, None, :], 0.0
    )
    out = out.reshape(-1, C)[:B]
    return out if v.dim() > 1 else out[:, 0]


def segmented_cummax(v: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative max that resets at segment starts."""
    return _segmented_scan(v, seg_start, torch.maximum, float("-inf"))


def composite_test_flat(
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    deltas: torch.Tensor,
    ts: torch.Tensor,
    ray_id: torch.Tensor,
    offsets: torch.Tensor,
    cap: torch.Tensor,
    valid: torch.Tensor,
    acc: dict,
    T_threshold: float = 1e-4,
) -> dict:
    """Resumable compositing of one flat block (vren.composite_test_fw
    semantics): contributions stop once the exclusive transmittance falls
    to T_threshold, and the carried T freezes at the value entering the
    first dead sample.

    Shapes as the reference: sigmas (B,), rgbs (B, 3), valid (B,), acc
    {opacity, depth, transmittance, alive: (N,), rgb: (N, 3)}. With a
    leading expert axis (sigmas (K, B), rgbs (K, B, 3), valid (K, B), acc
    entries (K, N[, 3])) the K experts share one set of segmented scans;
    deltas, ts, ray_id, offsets and cap are shared."""
    single = sigmas.dim() == 1
    if single:
        sigmas, rgbs, valid = sigmas[None], rgbs[None], valid[None]
        acc = {k: v[None] for k, v in acc.items()}
    E, B = sigmas.shape
    rid = ray_id.long()
    T_in = acc["transmittance"]                               # (E, N)
    mask = valid & acc["alive"][:, rid]
    seg_start = torch.arange(B, device=sigmas.device) == offsets[rid]
    sd = torch.where(mask, sigmas * deltas, 0.0)              # (E, B)
    within_incl = segmented_cumsum(sd.T, seg_start).T
    t_excl = torch.exp(-(within_incl - sd)) * T_in[:, rid]
    alpha = 1.0 - torch.exp(-sd)
    alive_s = t_excl > T_threshold
    w = alpha * t_excl * alive_s

    present = (cap > 0) & (offsets < B)
    ends = torch.where(present, offsets + cap - 1, 0).clamp_max(B - 1).long()
    # one segmented scan for every per-ray sum of the block: columns
    # [w | w*ts | w*r | w*g | w*b | sd where w > 0], each (E,)
    cols = torch.cat([
        w, w * ts, (w[..., None] * rgbs).permute(2, 0, 1).reshape(3 * E, B),
        torch.where(w > 0, sd, 0.0),
    ]).T
    seg = segmented_cumsum(cols, seg_start)[ends]             # (N, 6E)
    seg = torch.where(present[:, None], seg, 0.0).T.reshape(6, E, -1)
    opacity = acc["opacity"] + seg[0]
    depth = acc["depth"] + seg[1]
    rgb = acc["rgb"] + seg[2:5].permute(1, 2, 0)
    t_end = seg[5]

    dead_val = torch.where(mask & ~alive_s, t_excl, 0.0)
    t_frozen = segmented_cummax(dead_val.T, seg_start)[ends].T
    t_cont = T_in * torch.exp(-t_end)
    t_after = torch.where(t_frozen > 0.0, t_frozen, t_cont)
    out = {
        "opacity": opacity,
        "depth": depth,
        "rgb": rgb,
        "transmittance": t_after,
        "alive": acc["alive"] & (t_after > T_threshold),
    }
    return {k: v[0] for k, v in out.items()} if single else out
