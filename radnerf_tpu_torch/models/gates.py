"""Gates (twin of radnerf_tpu/models/gates.py): the Rad-NeRF ray gate, a
6-d ray descriptor (origin ‖ direction) -> MLP 6->64x4->K -> softmax; and
the Switch-NeRF point gate, a noisy top-k gate over a sample's features
(two MLPs: clean logits and noise scale) with the load estimate of its
balancing loss."""

from __future__ import annotations

import math

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


# ---------------------------------------------------------------------------
# Point gate (the Switch-NeRF baseline)
# ---------------------------------------------------------------------------

def init_point_gate(
    gen: torch.Generator,
    in_dim: int,
    n_experts: int,
    hidden: int = 64,
    n_hidden: int = 2,
    device=DEFAULT_DEVICE,
) -> dict:
    """Two MLPs in_dim -> 64x2 -> K: the clean logits (w_gate) and the
    noise scale (w_noise)."""
    return {
        "w_gate": init_mlp(gen, in_dim, hidden, n_experts, n_hidden,
                           device=device),
        "w_noise": init_mlp(gen, in_dim, hidden, n_experts, n_hidden,
                            device=device),
    }


def _normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0)))


def _prob_in_top_k(clean, noisy, noise_std, noisy_top, k: int):
    """P(a value stays in the top k under re-noising) (Shazeer et al.
    2017, eq. 9): a value now in the top k is compared with the (k+1)th
    noisy value, one outside with the kth."""
    thr_in = noisy_top[:, k:k + 1]          # (k+1)th largest
    thr_out = noisy_top[:, k - 1:k]         # kth largest
    is_in = noisy > thr_in
    prob_if_in = _normal_cdf((clean - thr_in) / noise_std)
    prob_if_out = _normal_cdf((clean - thr_out) / noise_std)
    return torch.where(is_in, prob_if_in, prob_if_out)


def top_k(x: torch.Tensor, k: int):
    """The k largest entries of each row and their indices, largest
    first, ties to the lower index (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def point_gate_logits(params: dict, x: torch.Tensor,
                      noise: torch.Tensor | None, noise_eps: float,
                      compute_dtype):
    """(clean, noisy, noise_std) float32 logits of x (N, in): noisy =
    clean + noise * (softplus(w_noise(x)) + noise_eps), or clean (and
    noise_std None) without `noise`."""
    clean = apply_mlp(params["w_gate"], x,
                      compute_dtype=compute_dtype).to(torch.float32)
    if noise is None:
        return clean, clean, None
    raw_std = apply_mlp(params["w_noise"], x,
                        compute_dtype=compute_dtype).to(torch.float32)
    noise_std = torch.nn.functional.softplus(raw_std) + noise_eps
    return clean, clean + noise.to(clean.device) * noise_std, noise_std


def apply_point_gate(
    params: dict,
    x: torch.Tensor,
    noise: torch.Tensor | None = None,
    gen: torch.Generator | None = None,
    k: int = 1,
    noise_eps: float = 1e-2,
    train: bool = True,
    compute_dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Noisy top-k gating of x (N, in). In training the logits take
    Gaussian noise, `noise` (N, K) or drawn from `gen` (on x's device);
    with train off the clean logits route.

    Returns gate (N, K), the softmax of the top k logits scattered into
    zeros; load (K,), the expected load (differentiable, through erf and
    softplus) in training with k < K, else the count of nonzero gates;
    top_idx (N, k)."""
    if train and noise is None:
        K = params["w_gate"]["b"][-1].shape[-1]
        noise = torch.randn((x.shape[0], K), generator=gen, device=x.device)
    clean, noisy, noise_std = point_gate_logits(
        params, x, noise if train else None, noise_eps, compute_dtype)
    n_experts = clean.shape[1]
    top_vals, top_idx_all = top_k(noisy, min(k + 1, n_experts))
    top_idx = top_idx_all[:, :k]
    top_w = torch.softmax(top_vals[:, :k], dim=1)
    gate = torch.zeros_like(noisy).scatter(1, top_idx, top_w)
    if noise_std is not None and k < n_experts:
        load = _prob_in_top_k(clean, noisy, noise_std, top_vals, k).sum(0)
    else:
        load = (gate > 0).to(torch.float32).sum(0)
    return gate, load, top_idx
