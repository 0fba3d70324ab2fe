"""MNGP, the Rad-NeRF sub-NeRF ensemble (twin of
radnerf_tpu/models/mngp.py): K experts with per-expert geo/rgb MLPs
(stacked on a leading (K, ...) axis) and per-expert occupancy grids,
sharing one hash encoder, or, with `shared_encoder=False` (the
reference's unshared_MNGP), each with its own hash table, stacked as
(K, L, T, 2)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..ops.hashgrid import incoherent_impl, init_hashgrid_table
from ..ops.sh import sh_encode_dir
from ..ops.trunc_exp import trunc_exp
from ..utils import trace
from .mlp import apply_mlp, init_stacked_mlp, slice_stacked
from .ngp import (
    NGPConfig, encode_positions, field_heads, pack_table, scene_box,
    update_density_grid,
)


@dataclasses.dataclass(frozen=True)
class MNGPConfig(NGPConfig):
    """NGPConfig + ensemble size (reference --model_zoo_size)."""

    n_experts: int = 2
    shared_encoder: bool = True   # False = unshared_MNGP


def init_mngp(gen: torch.Generator, cfg: MNGPConfig,
              device=DEFAULT_DEVICE) -> dict:
    """Hash table (or K tables, one after another), then geo MLPs, then
    rgb MLPs, all drawn from `gen`."""
    if cfg.shared_encoder:
        table = init_hashgrid_table(gen, cfg.hash, device=device)
    else:
        table = torch.stack([init_hashgrid_table(gen, cfg.hash, device=device)
                             for _ in range(cfg.n_experts)])
    return {
        "hash_table": table,
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
    xyz_min, xyz_max = scene_box(cfg, bbox)
    return {
        "density_grid": torch.zeros((K, C, G**3), device=device),
        "occ": torch.zeros((K, C, G, G, G), dtype=torch.bool, device=device),
        "xyz_min": torch.as_tensor(xyz_min, device=device),
        "xyz_max": torch.as_tensor(xyz_max, device=device),
    }


def expert_tables(params: dict, cfg: MNGPConfig) -> list:
    """The hash table each expert encodes with: the shared one K times, or
    the K tables as views of the stacked leaf (one `unbind`, so that the
    backward writes each table's gradient into one (K, L, T, 2) buffer)."""
    if cfg.shared_encoder:
        return [params["hash_table"]] * cfg.n_experts
    return list(params["hash_table"].unbind(0))


def pack_for_encode(params: dict, cfg: MNGPConfig,
                    impl: str | None = None):
    """The hash table packed once for many encodes of `impl` (default
    cfg.hash_impl): pack_brick3_table when the encode is brick3's, None for
    every other family. Unshared: a list of K packed tables (or Nones)."""
    if cfg.shared_encoder:
        return pack_table(params["hash_table"], cfg, impl)
    return [pack_table(t, cfg, impl) for t in params["hash_table"]]


def _encode(params, state, cfg: MNGPConfig, x: torch.Tensor, ind=None,
            impl: str | None = None, packed: torch.Tensor | None = None):
    """World positions (N, 3) -> (N, L*2) hash features of the shared
    table, or of expert `ind`'s (unshared); `packed` is that table packed
    (pack_for_encode's, or its entry `ind`)."""
    table = params["hash_table"]
    if not cfg.shared_encoder:
        table = table[ind]
    return encode_positions(table, state, cfg, x, impl, packed)


def mngp_density_expert(params, state, cfg: MNGPConfig, x: torch.Tensor,
                        ind: int, return_feat: bool = False,
                        impl: str | None = None,
                        packed: torch.Tensor | None = None):
    """sigma(x) of expert `ind` (and its geo features if asked);
    `packed` as in _encode."""
    feat = _encode(params, state, cfg, x, ind, impl=impl, packed=packed)
    with trace.span("render.mlp"):
        h = apply_mlp(slice_stacked(params["geo"], ind), feat,
                      compute_dtype=cfg.cdtype)
        sigmas = trunc_exp(h[:, 0])
    if return_feat:
        return sigmas, h[:, 1:]
    return sigmas


def mngp_forward_expert(params, state, cfg: MNGPConfig, x: torch.Tensor,
                        d: torch.Tensor, ind: int,
                        packed: torch.Tensor | None = None):
    """(sigma (N,), rgb (N, 3) float32) of expert `ind`."""
    feat = _encode(params, state, cfg, x, ind, packed=packed)
    return field_heads(slice_stacked(params["geo"], ind),
                       slice_stacked(params["rgb"], ind), feat, d, cfg)


def mngp_forward_all(params, state, cfg: MNGPConfig, x: torch.Tensor,
                     d: torch.Tensor):
    """Every expert on the same points: sigmas (K, N), rgbs (K, N, 3). A
    shared encoder encodes once for all K; unshared, each table once."""
    if cfg.shared_encoder:
        feats = _encode(params, state, cfg, x)[None]
    else:
        feats = torch.stack([encode_positions(t, state, cfg, x)
                             for t in expert_tables(params, cfg)])
    h = apply_mlp(params["geo"], feats, compute_dtype=cfg.cdtype)
    d_enc = sh_encode_dir(d, cfg.sh_degree).to(cfg.cdtype)
    K = cfg.n_experts
    rgb_in = torch.cat([d_enc[None].expand(K, -1, -1), h[..., 1:]], dim=-1)
    rgbs = apply_mlp(params["rgb"], rgb_in, out_act=cfg.rgb_act.lower(),
                     compute_dtype=cfg.cdtype)
    return trunc_exp(h[..., 0]), rgbs.to(torch.float32)


def expert_forward_fn(table: torch.Tensor, geo_p: dict, rgb_p: dict,
                      state: dict, cfg: MNGPConfig,
                      packed: torch.Tensor | None = None):
    """A `(x, d) -> (sigma, rgb)` closure of one expert's weights (its
    table, geo and rgb MLPs, already sliced), for the per-expert renders;
    `packed` is the table packed (pack_table)."""

    def fwd(x, d):
        feat = encode_positions(table, state, cfg, x, packed=packed)
        return field_heads(geo_p, rgb_p, feat, d, cfg)

    return fwd


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
    variant of the family (grid cells are spatially incoherent), on
    tables packed once for the update (the shared one, or each expert's).
    `draws[k]` are expert k's explicit draws (see update_density_grid)."""
    impl = incoherent_impl(cfg.hash_impl)
    packed = pack_for_encode(params, cfg, impl)
    grids, occs = [], []
    for k in range(cfg.n_experts):
        sub_state = {**state, "density_grid": state["density_grid"][k],
                     "occ": state["occ"][k]}
        pk = packed if cfg.shared_encoder else packed[k]
        new = update_density_grid(
            params, sub_state, cfg, gen, density_threshold, warmup,
            lambda x, k=k, pk=pk: mngp_density_expert(
                params, state, cfg, x, k, impl=impl, packed=pk),
            decay, None if draws is None else draws[k],
        )
        grids.append(new["density_grid"])
        occs.append(new["occ"])
    return {**state, "density_grid": torch.stack(grids),
            "occ": torch.stack(occs)}
