"""NGP field configuration and occupancy-grid maintenance (twin of
radnerf_tpu/models/ngp.py without the single-NGP field)."""

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


# ---------------------------------------------------------------------------
# Occupancy grid maintenance (twin of the grid half of
# radnerf_tpu/models/ngp.py). The random draws come from a
# torch.Generator on the grid's device, or are handed in explicitly (the
# tests hand in the draws the JAX key gave).
# ---------------------------------------------------------------------------

def all_cell_coords(cfg: NGPConfig, device) -> torch.Tensor:
    """(G^3, 3) int32 cell coords in the grid's linear layout
    (flat index = (x*G + y)*G + z)."""
    r = torch.arange(cfg.grid_size, dtype=torch.int32, device=device)
    xx, yy, zz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([xx, yy, zz], -1).reshape(-1, 3)


def coords_to_flat(coords: torch.Tensor, grid_size: int) -> torch.Tensor:
    return (
        coords[..., 0] * grid_size + coords[..., 1]
    ) * grid_size + coords[..., 2]


def cell_world_positions(
    coords: torch.Tensor, cascade: int, cfg: NGPConfig,
    gen: torch.Generator | None = None, jitter: torch.Tensor | None = None,
) -> torch.Tensor:
    """Jittered world position of cells in one cascade: s = min(2^(c-1),
    scale), half-cell jitter uniform in [-1, 1) (drawn from `gen` unless
    given). Within an f32 ulp or two of the jitted reference, which XLA
    rewrites in its own way; the points are random draws either way."""
    G = cfg.grid_size
    s = min(2.0 ** (cascade - 1), cfg.scale)
    half = s / G
    xyz = (coords.to(torch.float32) / (G - 1) * 2.0 - 1.0) * (s - half)
    if jitter is None:
        jitter = torch.rand(xyz.shape, generator=gen,
                            device=xyz.device) * 2.0 - 1.0
    return xyz + jitter * half


def _sample_cells(
    gen: torch.Generator | None, density_grid_c: torch.Tensor, M: int,
    density_threshold: float, grid_size: int, draws: dict | None = None,
) -> torch.Tensor:
    """M uniform + M occupied cell flat indices for one cascade. Occupied
    cells are drawn with replacement by inverse CDF on the occupancy mask;
    with no occupied cell the second half is a second uniform draw.

    `draws` {"uniform", "occ_rank", "fallback"}, each (M,) int, replaces
    the generator: cell indices, ranks in [0, max(total, 1)), and the
    fallback cells."""
    n_cells = density_grid_c.shape[0]
    dev = density_grid_c.device
    mask = (density_grid_c > density_threshold).to(torch.int64)
    cdf = torch.cumsum(mask, 0)
    total = cdf[-1]
    if draws is None:
        draws = {
            "uniform": torch.randint(0, n_cells, (M,), generator=gen,
                                     device=dev),
            # a rank in [0, total) without reading total on the host
            "occ_rank": (torch.rand(M, generator=gen, device=dev)
                         * total.clamp_min(1)).to(torch.int64)
            .clamp_max(total.clamp_min(1) - 1),
            "fallback": torch.randint(0, n_cells, (M,), generator=gen,
                                      device=dev),
        }
    u = draws["occ_rank"].to(device=dev, dtype=torch.int64)
    idx_occ = torch.searchsorted(cdf, u, right=True)
    idx_occ = torch.where(total > 0, idx_occ,
                          draws["fallback"].to(dev, torch.int64))
    return torch.cat([draws["uniform"].to(dev, torch.int64), idx_occ])


@torch.no_grad()
def update_density_grid(
    params: dict,
    state: dict,
    cfg: NGPConfig,
    gen: torch.Generator | None,
    density_threshold: float,
    warmup: bool,
    density_fn,
    decay: float = 0.95,
    draws: list | None = None,
) -> dict:
    """One occupancy-grid update. Returns the new state.

    Warmup: every cell of every cascade, once. Otherwise G^3/4 uniform +
    G^3/4 occupied cells per cascade, drawn with replacement; a cell drawn
    twice is set by one of its draws (which one is not fixed, as in the
    reference's scatter-set). `draws[c]` holds cascade c's explicit draws:
    "jitter" (n, 3) in [-1, 1), and outside warmup the `_sample_cells`
    draws."""
    C, G = cfg.cascades, cfg.grid_size
    grid = state["density_grid"]
    tmp = torch.zeros_like(grid)
    for c in range(C):
        dc = None if draws is None else draws[c]
        if warmup:
            coords = all_cell_coords(cfg, grid.device)
            flat = coords_to_flat(coords, G).long()
        else:
            flat = _sample_cells(gen, grid[c], G**3 // 4, density_threshold,
                                 G, dc)
            coords = torch.stack(
                [flat // (G * G), (flat // G) % G, flat % G], dim=-1)
        xyz = cell_world_positions(
            coords, c, cfg, gen, None if dc is None else dc["jitter"])
        tmp[c, flat] = density_fn(xyz).to(torch.float32)

    new_grid = torch.where(grid < 0, grid, torch.maximum(grid * decay, tmp))
    pos = new_grid > 0
    mean_density = torch.where(pos, new_grid, 0.0).sum() / pos.sum().clamp_min(1)
    thresh = torch.clamp_max(mean_density, density_threshold)
    occ = (new_grid > thresh).reshape(C, G, G, G)
    return {**state, "density_grid": new_grid, "occ": occ}
