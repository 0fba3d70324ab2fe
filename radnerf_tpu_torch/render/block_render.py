"""Block-NeRF, Mega-NeRF and NGP-zoo MoE rendering (twin of
radnerf_tpu/render/block_render.py).

block/mega: the K submodels share density and the occupancy grid; only
the rgb head differs, and the caller supplies the gating code (a spatial
assignment per ray). The rays are marched once and every sample runs all
K rgb heads, mixed by its ray's gate: with a shared density the weights
are the same for every k, so sum_k g_k (sum_s w_s rgb_k,s) = sum_s w_s
(sum_k g_k rgb_k,s). Depth and opacity are scaled by the gate's row sum.

moe_render_train: a zoo of complete NGPs (one table each), each expert
rendered as a single field, composed by a ray or position gate.
"""

from __future__ import annotations

import torch

from ..models.block import BlockNGPConfig, block_density, block_rgb_input
from ..models.gates import apply_ray_gate
from ..models.mlp import apply_mlp, slice_stacked
from ..models.mngp import expert_forward_fn
from ..models.ngp import pack_table
from .ml_render import _stack_results
from .render import RenderConfig, render_test, render_train


def _gated_forward_fn(params, state, cfg: BlockNGPConfig,
                      gating_code: torch.Tensor, dense_S: int | None = None,
                      packed: torch.Tensor | None = None):
    """A field closure that runs all K rgb heads and mixes them by each
    sample's ray's gate (gating_code (N_rays, K)): on the flat layout the
    render passes each sample's ray_id and the gate is gathered by it; on
    the dense layout the samples arrive ray-major, dense_S a ray, and
    each ray's gate is repeated dense_S times."""

    def fwd(x, d, ray_id=None):
        sigmas, h = block_density(params, state, cfg, x, return_feat=True,
                                  packed=packed)
        rgbs_k = apply_mlp(params["rgb"], block_rgb_input(h, d, cfg),
                           out_act=cfg.rgb_act.lower(),
                           compute_dtype=cfg.cdtype)          # (K, B, 3)
        if ray_id is not None:
            gate = gating_code[ray_id.long()]
        else:
            gate = gating_code.repeat_interleave(dense_S, dim=0)
        rgb = torch.einsum("nk,knc->nc", gate, rgbs_k.to(torch.float32))
        return sigmas, rgb

    return fwd


def _scale_by_gate(out: dict, gating_code: torch.Tensor) -> dict:
    gsum = gating_code.sum(dim=1)
    out["depth"] = out["depth"] * gsum
    out["opacity"] = out["opacity"] * gsum
    out["gating_code"] = gating_code
    return out


def block_render_train(
    params: dict,
    state: dict,
    cfg: BlockNGPConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gating_code: torch.Tensor,
    rcfg: RenderConfig,
    noise: torch.Tensor | None = None,
    gen: torch.Generator | None = None,
) -> dict:
    """Training render of (N, 3) rays under the gate (N, K):
    render_train's outputs with the rgb heads mixed, depth and opacity
    scaled by the gate's row sum, and gating_code."""
    out = render_train(
        None, state, cfg, rays_o, rays_d, rcfg,
        forward_fn=_gated_forward_fn(params, state, cfg, gating_code,
                                     dense_S=rcfg.samples_per_ray),
        noise=noise, gen=gen, forward_takes_ray_id=True)
    return _scale_by_gate(out, gating_code)


def block_render_test(
    params: dict,
    state: dict,
    cfg: BlockNGPConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    gating_code: torch.Tensor,
    rcfg: RenderConfig,
) -> dict:
    """Test-time render under the gate (N, K), on a table packed once per
    call; each sample takes its ray's gate."""
    packed = pack_table(params["hash_table"], cfg)
    out = render_test(
        None, state, cfg, rays_o, rays_d, rcfg,
        forward_fn=_gated_forward_fn(params, state, cfg, gating_code,
                                     dense_S=rcfg.test_block_samples,
                                     packed=packed),
        forward_takes_ray_id=True)
    return _scale_by_gate(out, gating_code)


mega_render_train = block_render_train
mega_render_test = block_render_test


def moe_render_train(
    zoo_params: dict,
    zoo_state: dict,
    cfg,
    gate_params: dict,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    rcfg: RenderConfig,
    gate_type: str = "ray",
    noises: torch.Tensor | None = None,
    gen: torch.Generator | None = None,
) -> dict:
    """The NGP-zoo MoE render: zoo_params stacked on a leading (K, ...)
    axis, hash tables included; zoo_state's occupancy (K, C, G, G, G).
    The gate sees origin ‖ origin (`position`) or origin ‖ direction
    (`ray`). Expert k renders as a single field with start jitter
    noises[k] (K, N), drawn from `gen` when not given.

    Returns rgb (N, 3), depth (N, K), opacity (N,), gating_code (N, K),
    gating_importance (K,), the per-expert flat buffers ws, deltas, ts,
    valid (K, B), rm_samples and total_samples."""
    if gate_type == "position":
        gate_in = torch.cat([rays_o, rays_o], dim=1)
    else:
        gate_in = torch.cat([rays_o, rays_d], dim=1)
    gate, importance, _ = apply_ray_gate(gate_params, gate_in)
    K = gate.shape[1]
    res = _stack_results([
        render_train(
            None, {**zoo_state, "occ": zoo_state["occ"][k]}, cfg, rays_o,
            rays_d, rcfg,
            forward_fn=expert_forward_fn(
                zoo_params["hash_table"][k],
                slice_stacked(zoo_params["geo"], k),
                slice_stacked(zoo_params["rgb"], k), zoo_state, cfg),
            noise=None if noises is None else noises[k], gen=gen)
        for k in range(K)])
    return {
        "rgb": torch.einsum("nk,knc->nc", gate, res["rgb"]),
        "depth": res["depth"].T,
        "opacity": torch.einsum("nk,kn->n", gate, res["opacity"]),
        "gating_code": gate,
        "gating_importance": importance,
        **{k: res[k] for k in ("ws", "deltas", "ts", "valid")},
        "rm_samples": res["rm_samples"].sum(),
        "total_samples": res["total_samples"].sum(),
    }
