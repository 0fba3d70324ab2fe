"""MipNeRF-360 distortion loss (twin of radnerf_tpu/ops/distortion.py)
in the DVGO-v2 prefix-sum form:

  loss_ray = sum_s 2*(wts_incl_s * ws_excl_s - ws_incl_s * wts_excl_s)
             + 1/3 * w_s^2 * delta_s

on the dense (N, S) layout with row scans, and on the flat (static-CSR)
layout with per-ray segmented scans; its gradient is autograd's.
"""

from __future__ import annotations

import torch

from .compositing import cumsum, segmented_cumsum


def distortion_loss(
    ws: torch.Tensor,
    deltas: torch.Tensor,
    ts: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Per-ray distortion loss (N,) of dense (N, S) weights, deltas, ts
    and validity mask."""
    w = torch.where(valid, ws, 0.0)
    wt = w * ts
    ws_incl = cumsum(w)
    wts_incl = cumsum(wt)
    ws_excl = ws_incl - w
    wts_excl = wts_incl - wt
    per_sample = 2.0 * (wts_incl * ws_excl - ws_incl * wts_excl) + (
        w * w * deltas / 3.0
    )
    return torch.where(valid, per_sample, 0.0).sum(dim=-1)


def distortion_loss_flat(
    ws: torch.Tensor,
    deltas: torch.Tensor,
    ts: torch.Tensor,
    ray_id: torch.Tensor,
    offsets: torch.Tensor,
    cap: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Per-ray distortion loss (N,) of one flat buffer (B,)."""
    B = ws.shape[0]
    seg_start = torch.arange(B, device=ws.device) == offsets[ray_id.long()]
    w = torch.where(valid, ws, 0.0)
    wt = w * ts
    ws_incl = segmented_cumsum(w, seg_start)
    wts_incl = segmented_cumsum(wt, seg_start)
    per_sample = 2.0 * (
        wts_incl * (ws_incl - w) - ws_incl * (wts_incl - wt)
    ) + (w * w * deltas / 3.0)
    loss_cum = segmented_cumsum(torch.where(valid, per_sample, 0.0),
                                seg_start)
    present = (cap > 0) & (offsets < B)
    ends = torch.where(present, offsets + cap - 1, 0).clamp_max(B - 1).long()
    return torch.where(present, loss_cum[ends], 0.0)
