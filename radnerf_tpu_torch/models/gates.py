"""The Rad-NeRF ray gate (twin of radnerf_tpu/models/gates.py): a 6-d ray
descriptor (origin ‖ direction) -> MLP 6->64x4->K -> softmax."""

from __future__ import annotations

import torch

from .. import DEFAULT_DEVICE
from .mlp import apply_mlp, init_mlp


def init_ray_gate(
    gen: torch.Generator,
    out_dim: int,
    hidden: int = 64,
    n_hidden: int = 4,
    device=DEFAULT_DEVICE,
) -> dict:
    return {"encoder": init_mlp(gen, 6, hidden, out_dim, n_hidden,
                                device=device)}


def apply_ray_gate(
    params: dict, x: torch.Tensor, compute_dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor, None]:
    """x (N, 6) -> gate (N, K) float32, importance (K,), None (dense soft
    gating has no routing)."""
    logits = apply_mlp(params["encoder"], x, compute_dtype=compute_dtype)
    gate = torch.softmax(logits.to(torch.float32), dim=1)
    return gate, gate.sum(dim=0), None
