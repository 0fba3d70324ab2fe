"""Loss layer (twin of radnerf_tpu/losses.py): a dict of per-element
losses whose means the trainer sums.

The MoE render returns its flat buffers per expert (ws, deltas, ts,
valid, ray_id, offsets, cap, each (K, ...)), so the distortion loss (off
at the default weight 0) is the mean over experts of the flat loss.
"""

from __future__ import annotations

import torch

from .ops.distortion import distortion_loss_flat


def nerf_loss(
    results: dict,
    target: dict,
    lambda_opacity: float = 1e-3,
    lambda_distortion: float = 0.0,
    lambda_cv_importance: float = 0.0,
    lambda_depth_mutual: float = 0.0,
) -> dict:
    loss = {}
    loss["rgb"] = (results["rgb"] - target["rgb"]) ** 2

    # opacity entropy: pushes opacity to 0 or 1
    o = results["opacity"] + 1e-10
    loss["opacity"] = lambda_opacity * (-o * torch.log(o))

    if lambda_distortion > 0 and "ws" in results:
        if "ray_id" not in results:
            raise NotImplementedError(
                "the port's distortion loss takes the flat layout only")
        args = [results[k] for k in ("ws", "deltas", "ts", "ray_id",
                                     "offsets", "cap", "valid")]
        if args[0].dim() == 2:        # (K, B) per-expert stacks
            per_expert = torch.stack([
                distortion_loss_flat(*(a[k] for a in args))
                for k in range(args[0].shape[0])
            ])
            loss["distortion"] = lambda_distortion * per_expert.mean(0)
        else:
            loss["distortion"] = lambda_distortion * distortion_loss_flat(
                *args)

    gate = results.get("gating_code")
    if lambda_cv_importance > 0 and gate is not None and gate.shape[-1] > 1:
        # cv^2 of gate importance: load balancing
        imp = results["gating_importance"].to(torch.float32)
        cv_sq = imp.var(unbiased=False) / (imp.mean() ** 2 + 1e-10)
        loss["cv_importance"] = lambda_cv_importance * cv_sq

    if lambda_depth_mutual > 0 and gate is not None and gate.shape[-1] > 1:
        # each expert's depth pulled toward the (no-grad) gated consensus
        depth = results["depth"]                              # (N, K)
        consensus = (depth * gate).sum(dim=1, keepdim=True).detach()
        loss["depth_mutual"] = lambda_depth_mutual * (depth - consensus) ** 2

    return loss


def total_loss(loss_d: dict) -> torch.Tensor:
    """Sum of the means."""
    return sum(v.mean() for v in loss_d.values())
