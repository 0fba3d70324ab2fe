"""The Block-NeRF and Mega-NeRF baselines (twin of
radnerf_tpu/models/block.py; the two are one architecture): a shared
hash encoder, a shared geo head and K rgb heads (stacked on a leading
(K, ...) axis), one shared occupancy grid. Which rgb head a ray takes is
the caller's spatial gate (render/block_render.py)."""

from __future__ import annotations

import dataclasses

import torch

from .. import DEFAULT_DEVICE
from ..ops.hashgrid import init_hashgrid_table
from ..ops.sh import sh_encode_dir
from ..ops.trunc_exp import trunc_exp
from .mlp import apply_mlp, init_mlp, init_stacked_mlp, slice_stacked
from .ngp import NGPConfig, encode_positions, init_ngp_state


@dataclasses.dataclass(frozen=True)
class BlockNGPConfig(NGPConfig):
    n_experts: int = 2


def init_block_ngp(gen: torch.Generator, cfg: BlockNGPConfig,
                   device=DEFAULT_DEVICE) -> dict:
    """Hash table, geo, then the K stacked rgb heads, drawn from `gen`."""
    return {
        "hash_table": init_hashgrid_table(gen, cfg.hash, device=device),
        "geo": init_mlp(gen, cfg.feat_dim, cfg.geo_hidden, 1 + cfg.geo_out,
                        cfg.geo_layers, device=device),
        "rgb": init_stacked_mlp(gen, cfg.n_experts, cfg.rgb_in_dim,
                                cfg.rgb_hidden, 3, cfg.rgb_layers,
                                device=device),
    }


init_block_ngp_state = init_ngp_state       # one shared grid


def block_density(params: dict, state: dict, cfg: BlockNGPConfig,
                  x: torch.Tensor, return_feat: bool = False,
                  packed: torch.Tensor | None = None):
    """The shared sigma(x), and the geo features (N, 16) if asked;
    `packed` is the table packed (pack_table)."""
    feat = encode_positions(params["hash_table"], state, cfg, x,
                            packed=packed)
    h = apply_mlp(params["geo"], feat, compute_dtype=cfg.cdtype)
    sigmas = trunc_exp(h[:, 0])
    if return_feat:
        return sigmas, h[:, 1:]
    return sigmas


def block_rgb_input(h: torch.Tensor, d: torch.Tensor,
                    cfg: BlockNGPConfig) -> torch.Tensor:
    """The rgb heads' input: SH directions ‖ geo features."""
    d_enc = sh_encode_dir(d, cfg.sh_degree).to(cfg.cdtype)
    return torch.cat([d_enc, h], dim=-1)


def block_forward(params: dict, state: dict, cfg: BlockNGPConfig,
                  x: torch.Tensor, d: torch.Tensor, ind: int,
                  packed: torch.Tensor | None = None):
    """(sigma (N,), rgb (N, 3) float32) through submodel `ind`'s rgb
    head."""
    sigmas, h = block_density(params, state, cfg, x, return_feat=True,
                              packed=packed)
    rgbs = apply_mlp(slice_stacked(params["rgb"], ind),
                     block_rgb_input(h, d, cfg),
                     out_act=cfg.rgb_act.lower(), compute_dtype=cfg.cdtype)
    return sigmas, rgbs.to(torch.float32)


# Mega-NeRF is the same architecture
MegaNGPConfig = BlockNGPConfig
init_mega_ngp = init_block_ngp
init_mega_ngp_state = init_block_ngp_state
mega_density = block_density
mega_forward = block_forward
