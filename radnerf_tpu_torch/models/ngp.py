"""NGP field configuration (twin of the config half of
radnerf_tpu/models/ngp.py)."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.hashgrid import HashGridConfig


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    """Static NGP field configuration (reference field constants)."""

    scale: float = 0.5
    rgb_act: str = "sigmoid"
    log2_T: int = 19
    grid_size: int = 128
    n_levels: int = 16
    n_features: int = 2
    base_resolution: int = 16
    geo_hidden: int = 64
    geo_layers: int = 1           # hidden layers in geo_net
    geo_out: int = 16             # feature dims beyond sigma
    rgb_hidden: int = 64
    rgb_layers: int = 2           # hidden layers in rgb_net
    sh_degree: int = 4
    compute_dtype: str = "float32"
    hash_impl: str = "auto"

    @property
    def cascades(self) -> int:
        return max(1 + int(math.ceil(math.log2(2 * self.scale))), 1)

    @property
    def hash(self) -> HashGridConfig:
        return HashGridConfig.for_scene_scale(
            self.scale,
            n_levels=self.n_levels,
            n_features=self.n_features,
            log2_table_size=self.log2_T,
            base_resolution=self.base_resolution,
        )

    @property
    def feat_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def rgb_in_dim(self) -> int:
        return self.sh_degree**2 + self.geo_out

    @property
    def cdtype(self) -> torch.dtype:
        if self.compute_dtype == "bfloat16":
            return torch.bfloat16
        return torch.float32


def scene_center_half(state: dict) -> tuple[torch.Tensor, torch.Tensor]:
    center = (state["xyz_min"] + state["xyz_max"]) * 0.5
    half = (state["xyz_max"] - state["xyz_min"]) * 0.5
    return center, half
