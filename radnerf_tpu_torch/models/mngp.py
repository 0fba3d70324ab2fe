"""MNGP, the Rad-NeRF sub-NeRF ensemble (twin of
radnerf_tpu/models/mngp.py): K experts sharing one hash encoder, with
per-expert geo/rgb MLPs (stacked on a leading (K, ...) axis) and
per-expert occupancy grids."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..ops.hashgrid import init_hashgrid_table
from ..ops.hashgrid_brick3 import hashgrid_encode_brick3_fwd_impl
from .mlp import init_stacked_mlp
from .ngp import NGPConfig


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


# hash_impl -> brick3 forward mode ('auto' is brick3 on an accelerator)
_BRICK3_MODES = {"auto": "runs", "brick3": "runs", "brick3_plain": "plain"}


def _encode(params, state, cfg: MNGPConfig, x: torch.Tensor,
            impl: str | None = None, packed: torch.Tensor | None = None):
    """World positions (N, 3) -> (N, L*2) hash features.

    `packed` is the table already packed by pack_brick3_table (callers
    that encode many batches pack once)."""
    _require_shared(cfg)
    impl = impl or cfg.hash_impl
    if impl not in _BRICK3_MODES:
        raise NotImplementedError(
            f"hash_impl {impl!r}: the port has the brick3 family only; "
            "the other families are queued in ROADMAP.md (port queue 1, "
            "'Off the main path')"
        )
    if cfg.cdtype != torch.bfloat16:
        raise NotImplementedError(
            "brick3 is bfloat16-only; the float32 encode (the reference's "
            "fallback to the tcnn-hash 'dedup' family) is queued in "
            "ROADMAP.md"
        )
    xn = (x - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
    xn = xn.clamp(0.0, 1.0)
    return hashgrid_encode_brick3_fwd_impl(
        params["hash_table"], xn, cfg.hash, _BRICK3_MODES[impl],
        packed=packed,
    )
