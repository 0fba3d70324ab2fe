"""Fused multiply-add in float32, as the reference computes it.

XLA's CPU backend contracts an elementwise `a * b + c` inside one fusion
into a single fused multiply-add (one rounding). Sample positions
(`t0 + k * dt`, `o + t * d`) and hash-grid coordinates (`x * scale + 0.5`)
are computed that way in the jitted JAX render, and a one-ulp change in
them can move a sample across a grid-cell boundary. The port therefore
defines these expressions as a fused multiply-add everywhere: in float64
here (the product of two float32 values is exact in float64, so the result
is the correctly rounded a*b+c except in double-rounding ties, about one
value in 2^29), and with `__fmaf_rn` inside the CUDA kernels.
"""

from __future__ import annotations

import torch


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 round(a * b + c) with one rounding, broadcasting a, b, c.

    `b` and `c` may be tensors or Python floats; a Python float is first
    rounded to float32, as a weakly typed JAX constant is."""
    def f64(v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.float64)
        return torch.tensor(v, dtype=torch.float32).to(torch.float64).item()

    return (f64(a) * f64(b) + f64(c)).to(torch.float32)
