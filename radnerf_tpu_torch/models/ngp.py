"""The NGP field (twin of radnerf_tpu/models/ngp.py): a multiresolution
hash encoding and two small MLPs (geo: features -> sigma and 16 geo
features; rgb: SH directions and geo features -> colour), and the
occupancy grid it keeps. Trainable parameters (hash table, geo and rgb
MLPs) and the state (density grid, occupancy, bbox) are separate dicts of
tensors."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..ops.hashgrid import (
    HashGridConfig, encode_dispatch, incoherent_impl, init_hashgrid_table,
    uses_brick3,
)
from ..ops.hashgrid_brick3 import pack_brick3_table
from ..ops.sh import sh_encode_dir
from ..ops.trunc_exp import trunc_exp
from .mlp import apply_mlp, init_mlp


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


def init_ngp(gen: torch.Generator, cfg: NGPConfig,
             device=DEFAULT_DEVICE) -> dict:
    """Hash table, then the geo MLP, then the rgb MLP, all drawn from
    `gen`."""
    return {
        "hash_table": init_hashgrid_table(gen, cfg.hash, device=device),
        "geo": init_mlp(gen, cfg.feat_dim, cfg.geo_hidden, 1 + cfg.geo_out,
                        cfg.geo_layers, device=device),
        "rgb": init_mlp(gen, cfg.rgb_in_dim, cfg.rgb_hidden, 3,
                        cfg.rgb_layers, device=device),
    }


def scene_box(cfg: NGPConfig, bbox: np.ndarray | None = None):
    """(xyz_min, xyz_max) float32: [-scale, scale]^3, or `bbox` (2, 3)."""
    if bbox is None:
        return (-np.ones(3, np.float32) * cfg.scale,
                np.ones(3, np.float32) * cfg.scale)
    return np.asarray(bbox[0], np.float32), np.asarray(bbox[1], np.float32)


def init_ngp_state(cfg: NGPConfig, bbox: np.ndarray | None = None,
                   device=DEFAULT_DEVICE) -> dict:
    """The density grid (C, G^3), the occupancy (C, G, G, G) and the scene
    bbox (`bbox` (2, 3) overrides [-scale, scale]^3)."""
    C, G = cfg.cascades, cfg.grid_size
    xyz_min, xyz_max = scene_box(cfg, bbox)
    return {
        "density_grid": torch.zeros((C, G**3), device=device),
        "occ": torch.zeros((C, G, G, G), dtype=torch.bool, device=device),
        "xyz_min": torch.as_tensor(xyz_min, device=device),
        "xyz_max": torch.as_tensor(xyz_max, device=device),
    }


def scene_center_half(state: dict) -> tuple[torch.Tensor, torch.Tensor]:
    center = (state["xyz_min"] + state["xyz_max"]) * 0.5
    half = (state["xyz_max"] - state["xyz_min"]) * 0.5
    return center, half


def pack_table(table: torch.Tensor, cfg: NGPConfig,
               impl: str | None = None) -> torch.Tensor | None:
    """`table` packed once for many encodes of `impl` (default
    cfg.hash_impl): pack_brick3_table when the encode is brick3's, None
    for every other family (they take the (L, T, 2) table as it is)."""
    if uses_brick3(impl or cfg.hash_impl, cfg.cdtype):
        return pack_brick3_table(table)
    return None


def encode_positions(table: torch.Tensor, state: dict, cfg: NGPConfig,
                     x: torch.Tensor, impl: str | None = None,
                     packed: torch.Tensor | None = None) -> torch.Tensor:
    """World positions (N, 3) -> (N, L*2) hash features of `table`
    through encode_dispatch (differentiable in the table: each family's
    backward is its table-gradient kernel); `packed` is pack_table's
    table, for callers that encode many batches."""
    xn = (x - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
    xn = xn.clamp(0.0, 1.0)
    return encode_dispatch(table, xn, cfg.hash, cfg.cdtype,
                           impl or cfg.hash_impl, packed=packed)


def field_heads(geo: dict, rgb: dict, feat: torch.Tensor,
                d: torch.Tensor, cfg: NGPConfig):
    """(sigma (N,), rgb (N, 3) float32) from hash features (N, L*2) and
    directions (N, 3), through one geo and one rgb MLP."""
    h = apply_mlp(geo, feat, compute_dtype=cfg.cdtype)
    d_enc = sh_encode_dir(d, cfg.sh_degree).to(cfg.cdtype)
    rgbs = apply_mlp(rgb, torch.cat([d_enc, h[:, 1:]], dim=-1),
                     out_act=cfg.rgb_act.lower(), compute_dtype=cfg.cdtype)
    return trunc_exp(h[:, 0]), rgbs.to(torch.float32)


def ngp_density(params: dict, state: dict, cfg: NGPConfig, x: torch.Tensor,
                return_feat: bool = False, impl: str | None = None,
                packed: torch.Tensor | None = None):
    """sigma(x) for world positions x (N, 3), and the geo features (N, 16)
    if asked; `impl` overrides cfg.hash_impl (the grid update passes
    incoherent_impl), `packed` as in encode_positions."""
    feat = encode_positions(params["hash_table"], state, cfg, x, impl,
                            packed)
    h = apply_mlp(params["geo"], feat, compute_dtype=cfg.cdtype)
    sigmas = trunc_exp(h[:, 0])
    if return_feat:
        return sigmas, h[:, 1:]
    return sigmas


def ngp_forward(params: dict, state: dict, cfg: NGPConfig, x: torch.Tensor,
                d: torch.Tensor, packed: torch.Tensor | None = None):
    """(sigma (N,), rgb (N, 3) float32) at positions x and directions d,
    both (N, 3)."""
    feat = encode_positions(params["hash_table"], state, cfg, x,
                            packed=packed)
    return field_heads(params["geo"], params["rgb"], feat, d, cfg)


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
    density_fn=None,
    decay: float = 0.95,
    draws: list | None = None,
) -> dict:
    """One occupancy-grid update. Returns the new state.

    Warmup: every cell of every cascade, once. Otherwise G^3/4 uniform +
    G^3/4 occupied cells per cascade, drawn with replacement; a cell drawn
    twice is set by one of its draws (which one is not fixed, as in the
    reference's scatter-set). `density_fn(x)` gives the densities (an
    ensemble passes its expert's); by default the field's own, through
    incoherent_impl(cfg.hash_impl), the plain-forward variant of the
    family (grid cells are spatially incoherent), on a table packed once
    for the update. `draws[c]` holds cascade c's explicit draws: "jitter"
    (n, 3) in [-1, 1), and outside warmup the `_sample_cells` draws."""
    if density_fn is None:
        impl = incoherent_impl(cfg.hash_impl)
        packed = pack_table(params["hash_table"], cfg, impl)
        density_fn = lambda x: ngp_density(params, state, cfg, x, impl=impl,
                                           packed=packed)
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
