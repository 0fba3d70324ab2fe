"""The sigma activation (twin of radnerf_tpu/ops/trunc_exp.py): forward
exp(x) in float32; backward g * exp(clamp(x, -15, 15)), computed in
float32 and returned in the input's dtype, so a bf16 input's gradient
cannot blow up."""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x32 = x.to(torch.float32)
        ctx.save_for_backward(x32)
        ctx.in_dtype = x.dtype
        return torch.exp(x32)

    @staticmethod
    def backward(ctx, g):
        (x32,) = ctx.saved_tensors
        return (g * torch.exp(x32.clamp(-15.0, 15.0))).to(ctx.in_dtype)


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
