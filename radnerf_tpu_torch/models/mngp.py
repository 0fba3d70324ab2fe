"""MNGP, the Rad-NeRF sub-NeRF ensemble (twin of
radnerf_tpu/models/mngp.py): K experts sharing one hash encoder, with
per-expert geo/rgb MLPs (stacked on a leading (K, ...) axis) and
per-expert occupancy grids."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..ops.hashgrid import (
    encode_dispatch, incoherent_impl, init_hashgrid_table, uses_brick3,
)
from ..ops.hashgrid_brick3 import pack_brick3_table
from ..ops.trunc_exp import trunc_exp
from .mlp import apply_mlp, init_stacked_mlp, slice_stacked
from .ngp import NGPConfig, update_density_grid


@dataclasses.dataclass(frozen=True)
class MNGPConfig(NGPConfig):
    """NGPConfig + ensemble size (reference --model_zoo_size)."""

    n_experts: int = 2
    shared_encoder: bool = True   # False = unshared_MNGP


def _require_shared(cfg: MNGPConfig) -> None:
    if not cfg.shared_encoder:
        raise NotImplementedError(
            "unshared_MNGP (per-expert hash tables) is queued in ROADMAP.md")


def init_mngp(gen: torch.Generator, cfg: MNGPConfig,
              device=DEFAULT_DEVICE) -> dict:
    """Hash table, then geo MLPs, then rgb MLPs, all drawn from `gen`."""
    _require_shared(cfg)
    return {
        "hash_table": init_hashgrid_table(gen, cfg.hash, device=device),
        "geo": init_stacked_mlp(
            gen, cfg.n_experts, cfg.feat_dim, cfg.geo_hidden,
            1 + cfg.geo_out, cfg.geo_layers, device=device,
        ),
        "rgb": init_stacked_mlp(
            gen, cfg.n_experts, cfg.rgb_in_dim, cfg.rgb_hidden, 3,
            cfg.rgb_layers, device=device,
        ),
    }


def init_mngp_state(cfg: MNGPConfig, bbox: np.ndarray | None = None,
                    device=DEFAULT_DEVICE) -> dict:
    """Per-expert density grids and occupancy, and the scene bbox."""
    C, G, K = cfg.cascades, cfg.grid_size, cfg.n_experts
    if bbox is None:
        xyz_min = -np.ones(3, np.float32) * cfg.scale
        xyz_max = np.ones(3, np.float32) * cfg.scale
    else:
        xyz_min = np.asarray(bbox[0], np.float32)
        xyz_max = np.asarray(bbox[1], np.float32)
    return {
        "density_grid": torch.zeros((K, C, G**3), device=device),
        "occ": torch.zeros((K, C, G, G, G), dtype=torch.bool, device=device),
        "xyz_min": torch.as_tensor(xyz_min, device=device),
        "xyz_max": torch.as_tensor(xyz_max, device=device),
    }


def pack_for_encode(params: dict, cfg: MNGPConfig,
                    impl: str | None = None) -> torch.Tensor | None:
    """The hash table packed once for many encodes of `impl` (default
    cfg.hash_impl): pack_brick3_table when the encode is brick3's, None for
    every other family (they take the (L, T, 2) table as it is)."""
    if uses_brick3(impl or cfg.hash_impl, cfg.cdtype):
        return pack_brick3_table(params["hash_table"])
    return None


def _encode(params, state, cfg: MNGPConfig, x: torch.Tensor,
            impl: str | None = None, packed: torch.Tensor | None = None):
    """World positions (N, 3) -> (N, L*2) hash features through
    encode_dispatch (differentiable in the table: each family's backward
    is its table-gradient kernel). `packed` is pack_for_encode's table
    (callers that encode many batches pack once)."""
    _require_shared(cfg)
    xn = (x - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
    xn = xn.clamp(0.0, 1.0)
    return encode_dispatch(params["hash_table"], xn, cfg.hash, cfg.cdtype,
                           impl or cfg.hash_impl, packed=packed)


def mngp_density_expert(params, state, cfg: MNGPConfig, x: torch.Tensor,
                        ind: int, return_feat: bool = False,
                        impl: str | None = None,
                        packed: torch.Tensor | None = None):
    """sigma(x) of expert `ind` (and its geo features if asked);
    `packed` as in _encode."""
    feat = _encode(params, state, cfg, x, impl=impl, packed=packed)
    h = apply_mlp(slice_stacked(params["geo"], ind), feat,
                  compute_dtype=cfg.cdtype)
    sigmas = trunc_exp(h[:, 0])
    if return_feat:
        return sigmas, h[:, 1:]
    return sigmas


@torch.no_grad()
def mngp_update_density_grids(
    params: dict,
    state: dict,
    cfg: MNGPConfig,
    gen: torch.Generator | None,
    density_threshold: float,
    warmup: bool,
    decay: float = 0.95,
    draws: list | None = None,
) -> dict:
    """Update all K per-expert grids, one expert after another; the
    density pass takes incoherent_impl(cfg.hash_impl), the plain-forward
    variant of the family (grid cells are spatially incoherent), on a
    table packed once for all experts. `draws[k]` are expert k's explicit
    draws (see update_density_grid)."""
    impl = incoherent_impl(cfg.hash_impl)
    packed = pack_for_encode(params, cfg, impl)
    grids, occs = [], []
    for k in range(cfg.n_experts):
        sub_state = {**state, "density_grid": state["density_grid"][k],
                     "occ": state["occ"][k]}
        new = update_density_grid(
            params, sub_state, cfg, gen, density_threshold, warmup,
            lambda x, k=k: mngp_density_expert(params, state, cfg, x, k,
                                               impl=impl, packed=packed),
            decay, None if draws is None else draws[k],
        )
        grids.append(new["density_grid"])
        occs.append(new["occ"])
    return {**state, "density_grid": torch.stack(grids),
            "occ": torch.stack(occs)}
