"""The Switch-NeRF baseline as train_other.py's OtherNeRFSystem builds it
(--model_type switch): its Trainer, which takes the batch in one pass."""

from __future__ import annotations

import torch

from . import common


def build_trainer(flags: list, model: dict, scene: dict, weights: dict,
                  gen_seed: int, device):
    """The system's Trainer on the benchmark's scene and weights."""
    from radnerf_tpu_torch.models.switch import (
        SwitchNGPConfig, init_switch_ngp_state,
    )
    from radnerf_tpu_torch.parallel.mesh import single_rank_mesh
    from radnerf_tpu_torch.train.other_trainer import OtherNeRFSystem
    from radnerf_tpu_torch.train.trainer import Trainer

    h = common.parse_flags(flags)
    if h.model_type != "switch":
        raise ValueError("this system trains --model_type switch")
    h.moe_training = False
    s = common.bare_system(OtherNeRFSystem, h)
    s.kind, s.anchors = "switch", None
    cfg = SwitchNGPConfig(scale=h.scale, log2_T=h.hash_table_size,
                          n_experts=h.model_zoo_size,
                          compute_dtype=h.compute_dtype,
                          grid_size=model["density_grid_size"])
    common.check_sizes(cfg, model)
    data = {"rays": scene["images"], "poses": scene["poses"],
            "directions": scene["directions"]}
    return Trainer(cfg, s.train_config(), common.nest(weights, "model"),
                   None, init_switch_ngp_state(cfg, device=device), data,
                   torch.Generator(device=device).manual_seed(gen_seed),
                   None, mesh=single_rank_mesh(device), **s.trainer_hooks())


def test_render(trainer):
    """The system's test-time render of rays (o, d) (its validation's
    render_chunk: the clean gate)."""
    from radnerf_tpu_torch.render.switch_render import switch_render_test

    def render(o, d):
        return switch_render_test(trainer.bundle["model"],
                                  trainer.model_state, trainer.cfg, o, d,
                                  trainer.rcfg)

    return render
