"""The Rad-NeRF mixture of experts as train_ml.py's NeRFSystem builds it:
its Trainer for the training cells, and its validation render
(render_rays_chunked over ml_render_test) for the render cells."""

from __future__ import annotations

import torch

from . import common


def _cfg(h, model: dict):
    """The system's field configuration from its options (the density
    grid's size, which no option sets, from the configuration file)."""
    from radnerf_tpu_torch.models.mngp import MNGPConfig

    return MNGPConfig(n_experts=h.model_zoo_size, scale=h.scale,
                      log2_T=h.hash_table_size, compute_dtype=h.compute_dtype,
                      hash_impl=h.hash_impl,
                      grid_size=model["density_grid_size"])


def build_trainer(flags: list, model: dict, scene: dict, weights: dict,
                  gen_seed: int, device):
    """The system's Trainer on the benchmark's scene and weights (the
    leaves are the trainer's own from here on: it updates them)."""
    from radnerf_tpu_torch.models.mngp import init_mngp_state
    from radnerf_tpu_torch.parallel.mesh import single_rank_mesh
    from radnerf_tpu_torch.train.trainer import NeRFSystem, Trainer

    h = common.parse_flags(flags)
    if not h.moe_training:
        raise ValueError("this system trains the MoE (--moe_training)")
    s = common.bare_system(NeRFSystem, h)
    cfg = _cfg(h, model)
    common.check_sizes(cfg, model)
    data = {"rays": scene["images"], "poses": scene["poses"],
            "directions": scene["directions"]}
    return Trainer(cfg, s.train_config(), common.nest(weights, "model"),
                   common.nest(weights, "gate"), init_mngp_state(
                       cfg, device=device), data,
                   torch.Generator(device=device).manual_seed(gen_seed),
                   None, mesh=single_rank_mesh(device), **s.trainer_hooks())


def test_render(trainer):
    """The system's test-time render of rays (o, d) at its current state,
    as its validation renders a chunk: {rgb, opacity, ...}."""
    from radnerf_tpu_torch.render.ml_render import ml_render_test

    b = trainer.bundle
    if trainer.tcfg.gate_type != "ray":
        raise ValueError("held-out rays of many views need the ray gate")

    def render(o, d):
        # the ray gate reads no image direction
        return ml_render_test(b["model"], trainer.model_state, trainer.cfg,
                              b["gate"], o, d, d, trainer.rcfg, "ray")

    return render


def build_viewer(flags: list, model: dict, weights: dict, occ, device):
    """The validation render of the system (render_rays_chunked, chunk
    --val_chunk) at the given weights and occupancy (K, G^3): returns
    render(directions, pose) -> {rgb, depth, opacity, total_samples,
    iterations}."""
    from radnerf_tpu_torch.models.mngp import init_mngp_state
    from radnerf_tpu_torch.render.ml_render import render_rays_chunked
    from radnerf_tpu_torch.train.trainer import (
        NeRFSystem, render_config,
    )

    h = common.parse_flags(flags)
    s = common.bare_system(NeRFSystem, h)
    cfg = _cfg(h, model)
    common.check_sizes(cfg, model)
    rcfg = render_config(cfg, s.train_config())
    state = init_mngp_state(cfg, device=device)
    G = cfg.grid_size
    state["occ"] = occ.reshape(cfg.n_experts, 1, G, G, G).contiguous()
    params = common.nest(weights, "model")
    gate = common.nest(weights, "gate")

    def render(dirs, pose, mean_dir):
        return render_rays_chunked(params, state, cfg, gate, dirs, pose,
                                   rcfg, chunk=h.val_chunk,
                                   gate_type=h.gate_type, mean_dir=mean_dir)

    return render, h.val_chunk
