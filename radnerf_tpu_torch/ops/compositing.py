"""Volume compositing (twin of radnerf_tpu/ops/compositing.py).

The flat sample layout: the training compositor, whose backward is
autograd through the segmented scans, and the resumable test-time
compositor. Per-ray sums are segmented scans over the ray-contiguous
sample buffer. They never sum across a segment boundary: a global cumsum
minus the prefix at each segment start would cancel catastrophically in
float32 over ~1e5 exp-activated samples.

The dense (N, S) layout: the same compositors on rows of S slots with a
validity mask; the transmittance's row scan (`cumsum`) sums in the
reference's order on every device.
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


def composite_train_flat(
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    deltas: torch.Tensor,
    ts: torch.Tensor,
    ray_id: torch.Tensor,
    offsets: torch.Tensor,
    cap: torch.Tensor,
    valid: torch.Tensor,
    T_threshold: float = 1e-4,
) -> dict:
    """Training compositing on the flat (static-CSR) layout: per-ray
    transmittance and outputs by segmented scans over the ray-sorted
    buffer. A sample whose exclusive transmittance has fallen to
    T_threshold contributes nothing and passes no gradient.

    Shapes as the reference: sigmas (B,), rgbs (B, 3), valid (B,); with a
    leading expert axis (sigmas (K, B), rgbs (K, B, 3), valid (K, B)) the
    K experts share one set of segmented scans. deltas, ts, ray_id,
    offsets and cap are shared. Returns opacity, depth (.., N), rgb
    (.., N, 3), ws (.., B) and vr_samples (.., N) int32."""
    single = sigmas.dim() == 1
    if single:
        sigmas, rgbs, valid = sigmas[None], rgbs[None], valid[None]
    E, B = sigmas.shape
    rid = ray_id.long()
    seg_start = torch.arange(B, device=sigmas.device) == offsets[rid]
    sd = torch.where(valid, sigmas * deltas, 0.0)             # (E, B)
    within_incl = segmented_cumsum(sd.T, seg_start).T
    t_excl = torch.exp(-(within_incl - sd))
    alpha = 1.0 - torch.exp(-sd)
    w = alpha * t_excl * (t_excl > T_threshold)

    # rays pushed wholly past the buffer end contribute nothing; a
    # truncated ray reads its sum at B - 1 (the samples that fit)
    present = (cap > 0) & (offsets < B)
    ends = torch.where(present, offsets + cap - 1, 0).clamp_max(B - 1).long()
    # one segmented scan for every per-ray sum: columns
    # [w | w*ts | w*r | w*g | w*b | (w > 0)], each (E,)
    cols = torch.cat([
        w, w * ts, (w[..., None] * rgbs).permute(2, 0, 1).reshape(3 * E, B),
        (w > 0).to(w.dtype),
    ]).T
    seg = segmented_cumsum(cols, seg_start)[ends]             # (N, 6E)
    seg = torch.where(present[:, None], seg, 0.0).T.reshape(6, E, -1)
    out = {
        "opacity": seg[0],
        "depth": seg[1],
        "rgb": seg[2:5].permute(1, 2, 0),
        "ws": w,
        "vr_samples": seg[5].round().to(torch.int32),
    }
    return {k: v[0] for k, v in out.items()} if single else out


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


# ---------------------------------------------------------------------------
# The dense (N, S) layout: every ray's samples in a row of S slots, a
# validity mask, and per-row scans.

_SCAN_BASE = 16


def _window_sums(v: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Over the last axis (at most _SCAN_BASE long): out[i] = v[0] + ... +
    v[i], or with `reverse` v[i] + ... + v[-1], each summed from the left
    from 0.0 in float32 (one masked add per position)."""
    b = v.shape[-1]
    idx = torch.arange(b, device=v.device)
    out = torch.zeros_like(v)
    for k in range(b):
        if reverse:       # lane i adds v[i + k]
            term = torch.cat([v[..., k:], v.new_zeros(v.shape[:-1] + (k,))],
                             dim=-1)
            out = out + term
        else:             # lane i adds v[k] where k <= i
            out = out + torch.where(idx >= k, v[..., k:k + 1], 0.0)
    return out


def _blocked_scan(v: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis (suffix sums with
    `reverse`) in the order XLA's CPU backend sums `jnp.cumsum` (its
    reduce-window rewrite, base 16): the axis zero-padded at its end to
    blocks of 16, each block summed from the left within itself, and the
    blocks' totals scanned the same way and added to the blocks after
    (before, reversed) them."""
    n = v.shape[-1]
    b = _SCAN_BASE
    if n <= b:
        return _window_sums(v, reverse)
    pad = (-n) % b
    if pad:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (pad,))], dim=-1)
    blocks = v.reshape(v.shape[:-1] + (-1, b))
    within = _window_sums(blocks, reverse)
    tot = within[..., -1] if not reverse else within[..., 0]
    inc = _blocked_scan(tot, reverse)
    zero = inc.new_zeros(inc.shape[:-1] + (1,))
    if reverse:
        carry = torch.cat([inc[..., 1:], zero], dim=-1)
    else:
        carry = torch.cat([zero, inc[..., :-1]], dim=-1)
    out = (within + carry[..., None]).reshape(v.shape)
    return out[..., :n]


class _Cumsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        return _blocked_scan(v, reverse=False)

    @staticmethod
    def backward(ctx, g):
        return _blocked_scan(g, reverse=True)


def cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumsum over the last axis, summed in one fixed
    order on every device: the reference's (`jnp.cumsum` on XLA's CPU
    backend), bit for bit, forward and backward (the suffix sums of the
    gradient). torch.cumsum accumulates in float64 on the CPU and scans in
    parallel on the card, so it agrees with neither."""
    return _Cumsum.apply(v)


def composite_weights(
    sigmas: torch.Tensor,
    deltas: torch.Tensor,
    valid: torch.Tensor,
    T_threshold: float = 1e-4,
    prev_transmittance: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample weights w = alpha * T_exclusive * alive on (N, S) rows,
    T_exclusive = exp(-(cumsum(sd) - sd)) (times the carry-in
    `prev_transmittance` (N,)), alive while it is above T_threshold: a
    sample past the cutoff contributes nothing and passes no gradient.

    Returns (w (N, S), T_after (N,)): the transmittance after the row,
    frozen at its value entering the first dead sample if the ray died in
    the row."""
    sd = torch.where(valid, sigmas * deltas, 0.0)
    alpha = 1.0 - torch.exp(-sd)
    t_excl = torch.exp(-(cumsum(sd) - sd))
    if prev_transmittance is not None:
        t_excl = t_excl * prev_transmittance[..., None]
    alive = t_excl > T_threshold
    w = alpha * t_excl * alive
    dead = ~alive
    t_frozen = torch.where(dead, t_excl, 0.0).amax(dim=-1)
    t_last = t_excl[..., -1] * (1.0 - alpha[..., -1])
    t_after = torch.where(dead.any(dim=-1), t_frozen, t_last)
    return w, t_after


def composite_train(
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    deltas: torch.Tensor,
    ts: torch.Tensor,
    valid: torch.Tensor,
    T_threshold: float = 1e-4,
) -> dict:
    """Training compositing on the dense layout: sigmas, deltas, ts, valid
    (..., N, S), rgbs (..., N, S, 3), any leading axes (the experts').
    Returns opacity, depth (..., N), rgb (..., N, 3), ws (..., N, S) and
    vr_samples (..., N) int32, the samples that contributed."""
    w, _ = composite_weights(sigmas, deltas, valid, T_threshold)
    return {
        "opacity": w.sum(dim=-1),
        "depth": (w * ts).sum(dim=-1),
        "rgb": (w[..., None] * rgbs).sum(dim=-2),
        "ws": w,
        "vr_samples": (w > 0).sum(dim=-1, dtype=torch.int32),
    }


def composite_test_block(
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    deltas: torch.Tensor,
    ts: torch.Tensor,
    valid: torch.Tensor,
    acc: dict,
    T_threshold: float = 1e-4,
) -> dict:
    """One resumable compositing block of the dense test layout
    (vren.composite_test_fw semantics): acc carries {opacity, depth,
    transmittance, alive (N,), rgb (N, 3)}; a dead ray passes through
    unchanged. Returns the updated carry."""
    T_in = acc["transmittance"]
    mask = valid & acc["alive"][:, None]
    w, t_after = composite_weights(sigmas, deltas, mask, T_threshold,
                                   prev_transmittance=T_in)
    return {
        "opacity": acc["opacity"] + w.sum(dim=-1),
        "depth": acc["depth"] + (w * ts).sum(dim=-1),
        "rgb": acc["rgb"] + (w[..., None] * rgbs).sum(dim=-2),
        "transmittance": t_after,
        "alive": acc["alive"] & (t_after > T_threshold),
    }
