"""Switch-NeRF rendering (twin of radnerf_tpu/render/switch_render.py):
the single-field render with the switch model's point-gated field, its
per-sample gate results returned for the load-balancing loss."""

from __future__ import annotations

import torch

from ..models.ngp import pack_table
from ..models.switch import SwitchNGPConfig, switch_forward
from .render import RenderConfig, render_test, render_train


def switch_render_train(
    params: dict,
    state: dict,
    cfg: SwitchNGPConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    rcfg: RenderConfig,
    noise: torch.Tensor | None = None,
    gate_noise: torch.Tensor | None = None,
    gen: torch.Generator | None = None,
) -> dict:
    """Training render of (N, 3) rays (render_train's outputs) and the
    gate's: gating_code (P, K) and gating_importance (K,). The gate runs
    on every slot, padding included (the flat buffer's B slots, or the
    dense layout's N x S, a pad slot's point at its ray's origin clamped
    into the box), so the load counts the padding slots, as in the
    reference. `noise` (N,) is the start jitter, `gate_noise` (P, K) the
    gate's Gaussian noise, one row a slot; either is drawn from `gen`
    when not given."""
    out = render_train(
        None, state, cfg, rays_o, rays_d, rcfg,
        forward_fn=lambda x, d: switch_forward(
            params, state, cfg, x, d, noise=gate_noise, gen=gen,
            train=True),
        noise=noise, gen=gen)
    gr = out.pop("gate_results")
    out["gating_code"] = gr["code"]
    out["gating_importance"] = gr["importance"]
    return out


def switch_render_test(
    params: dict,
    state: dict,
    cfg: SwitchNGPConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    rcfg: RenderConfig,
) -> dict:
    """Test-time render through the clean (noise-free) gate, on a table
    packed once per call (render_test's outputs)."""
    packed = pack_table(params["hash_table"], cfg)
    return render_test(
        None, state, cfg, rays_o, rays_d, rcfg,
        forward_fn=lambda x, d: switch_forward(params, state, cfg, x, d,
                                               train=False, packed=packed))
