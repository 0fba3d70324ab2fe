"""The sigma activation (twin of radnerf_tpu/ops/trunc_exp.py), forward
only: exp(x) in float32. The clamped backward, g * exp(clamp(x, -15, 15)),
comes with the training slice."""

from __future__ import annotations

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.to(torch.float32))
