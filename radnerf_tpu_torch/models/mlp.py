"""Small MLPs (twin of radnerf_tpu/models/mlp.py).

Parameters are plain dicts {"w": [...], "b": [...]} in the JAX layout:
w[i] is (in, out) and the layer is `h @ w + b`. A stacked (per-expert)
MLP carries a leading (K, ...) axis on every leaf; `apply_mlp` takes
either, so the JAX package's vmap over experts becomes a batched matmul.
Dense layers with biases and He-uniform init, as in the reference port.
"""

from __future__ import annotations

import math

import torch

from .. import DEFAULT_DEVICE


def _he_uniform(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    bound = math.sqrt(6.0 / shape[-2])
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * bound


def _layer_dims(in_dim, hidden_dim, out_dim, n_hidden):
    dims = [in_dim] + [hidden_dim] * n_hidden + [out_dim]
    return list(zip(dims[:-1], dims[1:]))


def init_mlp(
    gen: torch.Generator,
    in_dim: int,
    hidden_dim: int,
    out_dim: int,
    n_hidden: int,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """MLP with `n_hidden` hidden ReLU layers of width `hidden_dim`
    (n_hidden + 1 weight matrices). Draws come from `gen` on the CPU, so
    a seed gives the same weights on every device."""
    dims = _layer_dims(in_dim, hidden_dim, out_dim, n_hidden)
    return {
        "w": [_he_uniform(gen, d, dtype).to(device) for d in dims],
        "b": [torch.zeros(d[1], dtype=dtype, device=device) for d in dims],
    }


def init_stacked_mlp(
    gen: torch.Generator,
    n_stack: int,
    in_dim: int,
    hidden_dim: int,
    out_dim: int,
    n_hidden: int,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> dict:
    """Per-expert MLP weights stacked on a leading (K, ...) axis."""
    dims = _layer_dims(in_dim, hidden_dim, out_dim, n_hidden)
    return {
        "w": [
            _he_uniform(gen, (n_stack,) + d, dtype).to(device) for d in dims
        ],
        "b": [
            torch.zeros((n_stack, d[1]), dtype=dtype, device=device)
            for d in dims
        ],
    }


def apply_mlp(
    params: dict,
    x: torch.Tensor,
    out_act: str | None = None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """ReLU MLP; `out_act` in {None, 'sigmoid', 'exp'}.

    x (..., B, in) with stacked weights (K, in, out) gives (K, B, out).
    Each matmul rounds its float32-accumulated result to `compute_dtype`,
    as the reference's `preferred_element_type` does."""
    h = x.to(compute_dtype)
    n = len(params["w"])
    for i in range(n):
        w = params["w"][i].to(compute_dtype)
        b = params["b"][i].to(compute_dtype)
        h = torch.matmul(h, w) + b.unsqueeze(-2)
        if i < n - 1:
            h = torch.relu(h)
    if out_act == "sigmoid":
        # the logistic as XLA evaluates it: exp, add and divide each
        # rounded to the compute dtype (torch.sigmoid rounds once, which
        # differs by one bf16 ulp on a third of the values)
        h = 1.0 / (1.0 + torch.exp(-h))
    elif out_act == "exp":
        h = torch.exp(h)
    return h
