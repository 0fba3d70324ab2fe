"""Render configuration (twin of the config half of
radnerf_tpu/render/render.py)."""

from __future__ import annotations

import dataclasses

import torch

from ..ops.marching import MarchConfig

MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.01


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render-time knobs of the test-time render; the defaults
    (128 / 24 / 512 at chunk 4096) are the reference's joint optimum for
    the flat layout."""

    exp_step_factor: float = 0.0       # 1/256 when scale > 0.5
    T_threshold: float = 1e-4
    samples_per_ray: int = 192         # S: per-ray occupied-sample cap
    max_samples: int = MAX_SAMPLES
    random_bg: bool = False
    test_block_samples: int = 128      # per-iteration per-ray sample cap
    test_k_block: int = 512            # lattice candidates examined per iter
    test_layout: str = "flat"
    test_budget_per_ray: int = 24
    union_sampling: bool = True
    # the training-only fields (layout, budget_per_ray,
    # union_budget_factor) come with the training slice

    def march(self, cfg) -> MarchConfig:
        return MarchConfig(
            scale=cfg.scale,
            cascades=cfg.cascades,
            grid_size=cfg.grid_size,
            exp_step_factor=self.exp_step_factor,
            max_samples=self.max_samples,
            samples_per_ray=self.samples_per_ray,
        )


def background_color(
    rcfg: RenderConfig,
    gen: torch.Generator | None,
    device=None,
) -> torch.Tensor:
    """White for synthetic scenes (exp_step_factor == 0), else black, or a
    random color drawn from `gen` when rcfg.random_bg."""
    if rcfg.exp_step_factor == 0.0:
        return torch.ones(3, device=device)
    if rcfg.random_bg and gen is not None:
        return torch.rand(3, generator=gen).to(device)
    return torch.zeros(3, device=device)
