"""The Switch-NeRF baseline (twin of radnerf_tpu/models/switch.py): one
shared hash encoder, a noisy top-1 point gate over the encoded features,
K feature MLPs (32 -> 64x2 -> 32) mixed by the sparse gate, then one
shared geo and rgb head and one shared occupancy grid. The K feature
MLPs run as one stacked apply_mlp, (K, N, 32)."""

from __future__ import annotations

import dataclasses

import torch

from .. import DEFAULT_DEVICE
from ..ops.hashgrid import init_hashgrid_table
from ..ops.sh import sh_encode_dir
from ..ops.trunc_exp import trunc_exp
from ..utils import trace
from .gates import apply_point_gate, init_point_gate
from .mlp import apply_mlp, init_mlp, init_stacked_mlp
from .ngp import NGPConfig, encode_positions, init_ngp_state


@dataclasses.dataclass(frozen=True)
class SwitchNGPConfig(NGPConfig):
    n_experts: int = 2
    num_topk: int = 1
    inter_layers: int = 2


def init_switch_ngp(gen: torch.Generator, cfg: SwitchNGPConfig,
                    device=DEFAULT_DEVICE) -> dict:
    """Hash table, the K feature MLPs, the gate, geo and rgb, all drawn
    from `gen`."""
    return {
        "hash_table": init_hashgrid_table(gen, cfg.hash, device=device),
        "inter": init_stacked_mlp(gen, cfg.n_experts, cfg.feat_dim, 64,
                                  cfg.feat_dim, cfg.inter_layers,
                                  device=device),
        "gate": init_point_gate(gen, cfg.feat_dim, cfg.n_experts,
                                device=device),
        "geo": init_mlp(gen, cfg.feat_dim, cfg.geo_hidden, 1 + cfg.geo_out,
                        cfg.geo_layers, device=device),
        "rgb": init_mlp(gen, cfg.rgb_in_dim, cfg.rgb_hidden, 3,
                        cfg.rgb_layers, device=device),
    }


init_switch_ngp_state = init_ngp_state      # one shared grid


def switch_density(
    params: dict,
    state: dict,
    cfg: SwitchNGPConfig,
    x: torch.Tensor,
    noise: torch.Tensor | None = None,
    gen: torch.Generator | None = None,
    train: bool = False,
    return_feat: bool = False,
    packed: torch.Tensor | None = None,
):
    """sigma(x) through the gated feature mixture; with `return_feat`,
    (sigma, geo features (N, 16), gate results {code (N, K), importance
    (K,), indice (N, k)}). `noise` and `gen` are the gate's
    (apply_point_gate); `packed` is the table packed (pack_table)."""
    feat = encode_positions(params["hash_table"], state, cfg, x,
                            packed=packed)
    with trace.span("render.gate"):
        gate, load, top_idx = apply_point_gate(
            params["gate"], feat, noise, gen, k=cfg.num_topk, train=train,
            compute_dtype=cfg.cdtype)
    with trace.span("render.mlp"):
        inter = apply_mlp(params["inter"], feat, compute_dtype=cfg.cdtype)
        # the reference's bf16 einsum: products summed in float32, the sum
        # rounded once to the compute dtype
        post = torch.einsum("nk,knf->nf", gate.to(cfg.cdtype).float(),
                            inter.float()).to(cfg.cdtype)
        h = apply_mlp(params["geo"], post, compute_dtype=cfg.cdtype)
        sigmas = trunc_exp(h[:, 0])
    if return_feat:
        return sigmas, h[:, 1:], {"code": gate, "importance": load,
                                  "indice": top_idx}
    return sigmas


def switch_forward(
    params: dict,
    state: dict,
    cfg: SwitchNGPConfig,
    x: torch.Tensor,
    d: torch.Tensor,
    noise: torch.Tensor | None = None,
    gen: torch.Generator | None = None,
    train: bool = False,
    packed: torch.Tensor | None = None,
):
    """(sigma (N,), rgb (N, 3) float32, gate results) at positions x and
    directions d, both (N, 3)."""
    sigmas, h, gate_results = switch_density(
        params, state, cfg, x, noise, gen, train, return_feat=True,
        packed=packed)
    with trace.span("render.mlp"):
        d_enc = sh_encode_dir(d, cfg.sh_degree).to(cfg.cdtype)
        rgbs = apply_mlp(params["rgb"], torch.cat([d_enc, h], dim=-1),
                         out_act=cfg.rgb_act.lower(),
                         compute_dtype=cfg.cdtype)
    return sigmas, rgbs.to(torch.float32), gate_results
