"""Multiresolution hash-grid configuration (twin of the config half of
radnerf_tpu/ops/hashgrid.py; Instant-NGP / tcnn semantics):

  scale_l = N_min * b**l - 1,  res_l = ceil(scale_l) + 1,
  pos = x * scale_l + 0.5 for x in [0, 1]^3, trilinear over floor(pos).

The port's encoder is the brick3 layout (ops/hashgrid_brick3.py); the
tcnn-hash encoders are queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Static configuration of the hash-grid encoder (reference field:
    L=16, F=2, log2_T=19, N_min=16)."""

    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.3819128800

    @staticmethod
    def for_scene_scale(
        scale: float,
        n_levels: int = 16,
        n_features: int = 2,
        log2_table_size: int = 19,
        base_resolution: int = 16,
        max_resolution_mult: float = 2048.0,
    ) -> "HashGridConfig":
        """b chosen so the finest level reaches 2048 * scale."""
        b = math.exp(
            math.log(max_resolution_mult * scale / base_resolution)
            / (n_levels - 1)
        )
        return HashGridConfig(
            n_levels=n_levels,
            n_features=n_features,
            log2_table_size=log2_table_size,
            base_resolution=base_resolution,
            per_level_scale=b,
        )

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_scales(self) -> np.ndarray:
        l = np.arange(self.n_levels)
        return (
            self.base_resolution * self.per_level_scale**l - 1.0
        ).astype(np.float32)

    def level_resolutions(self) -> np.ndarray:
        return (np.ceil(self.level_scales()) + 1).astype(np.int64)


def init_hashgrid_table(
    gen: torch.Generator,
    cfg: HashGridConfig,
    dtype=torch.float32,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """tcnn's default init: (L, T, F) uniform in [-1e-4, 1e-4]."""
    shape = (cfg.n_levels, cfg.table_size, cfg.n_features)
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return (u * 2e-4 - 1e-4).to(device)


def _cm_out(o0: torch.Tensor, o1: torch.Tensor) -> torch.Tensor:
    """(L, N) per-feature sums -> (N, L*F) level-major tcnn layout."""
    L, N = o0.shape
    return torch.stack([o0, o1], dim=1).permute(2, 0, 1).reshape(N, L * 2)
