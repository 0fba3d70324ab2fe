"""Single-field rendering, training and test time (twin of the flat
layout of radnerf_tpu/render/render.py), and the render configuration.

Training: AABB intersection, the flat march of the field's occupancy
grid, the field on every marched sample, flat compositing, the
background. Test time: the reference's `lax.while_loop` of flat march
blocks is a Python loop whose condition is read back from the device once
per iteration; each ray keeps a resumable compositing carry.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.ngp import NGPConfig, ngp_forward, pack_table, scene_center_half
from ..ops.compositing import composite_test_flat, composite_train_flat
from ..ops.fma import fma32
from ..ops.intersection import scene_near_far
from ..ops.marching import (
    MarchConfig, march_rays_test_flat, march_rays_train_flat,
)

DENSE_LAYOUT = ("the dense sample layout is not ported yet (ROADMAP.md "
                "queue 1, item 5, the dense-layout bullet)")

MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.01


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render knobs. Test time: the defaults (128 / 24 / 512 at
    chunk 4096) are the reference's joint optimum for the flat layout.
    Training: the flat layout's static budget B = N * budget_per_ray,
    scaled for the MoE union stream by union_budget_factor (0.0 = the
    number of experts)."""

    exp_step_factor: float = 0.0       # 1/256 when scale > 0.5
    T_threshold: float = 1e-4
    samples_per_ray: int = 192         # S: per-ray occupied-sample cap
    max_samples: int = MAX_SAMPLES
    random_bg: bool = False
    test_block_samples: int = 128      # per-iteration per-ray sample cap
    test_k_block: int = 512            # lattice candidates examined per iter
    test_layout: str = "flat"
    test_budget_per_ray: int = 24
    layout: str = "dense"              # training: "dense" (N, S) | "flat"
    budget_per_ray: int = 64           # flat layout: B = N * budget_per_ray
    union_sampling: bool = True
    union_budget_factor: float = 0.0

    def march(self, cfg) -> MarchConfig:
        return MarchConfig(
            scale=cfg.scale,
            cascades=cfg.cascades,
            grid_size=cfg.grid_size,
            exp_step_factor=self.exp_step_factor,
            max_samples=self.max_samples,
            samples_per_ray=self.samples_per_ray,
        )


def background_color(
    rcfg: RenderConfig,
    gen: torch.Generator | None,
    device,
) -> torch.Tensor:
    """White for synthetic scenes (exp_step_factor == 0), else black, or a
    random color drawn from `gen` when rcfg.random_bg; on `device`."""
    if rcfg.exp_step_factor == 0.0:
        return torch.ones(3, device=device)
    if rcfg.random_bg and gen is not None:
        return torch.rand(3, generator=gen, device=gen.device).to(device)
    return torch.zeros(3, device=device)


def _fwd_out(out):
    """A field closure's (sigmas, rgbs) and its optional third item, the
    per-sample extras."""
    if isinstance(out, tuple) and len(out) == 3:
        return out
    return out[0], out[1], None


def render_train(
    params: dict | None,
    state: dict,
    cfg: NGPConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    rcfg: RenderConfig,
    forward_fn=None,
    noise: torch.Tensor | None = None,
    gen: torch.Generator | None = None,
    forward_takes_ray_id: bool = False,
) -> dict:
    """Training-time render of (N, 3) rays, differentiable in `params`.

    `forward_fn(x, d) -> (sigmas, rgbs[, extras])` overrides the field
    (ensembles pass an expert's closure); with `forward_takes_ray_id` it
    is called as forward_fn(x, d, ray_id=...), each sample's ray. A third
    item it returns comes back as "gate_results". `noise` (N,) is the
    per-ray start jitter in [0, 1), drawn from `gen` when not given; `gen`
    also draws the random background (rcfg.random_bg).

    Returns rgb (N, 3), depth (N,), opacity (N,), the flat buffers ws,
    ts, deltas, valid, ray_id (B,) and offsets, cap, n_samples (N,),
    rm_samples, budget_util (the share of the B slots used),
    total_samples and vr_samples."""
    if rcfg.layout != "flat":
        raise NotImplementedError(DENSE_LAYOUT)
    if forward_fn is None:
        forward_fn = lambda x, d: ngp_forward(params, state, cfg, x, d)
    dev = rays_o.device
    if noise is None:
        noise = torch.rand(rays_o.shape[0], generator=gen, device=dev)
    center, half = scene_center_half(state)
    # the march is not differentiated (the reference's stop_gradient
    # outputs): rays that carry a gradient reach the loss through the
    # sample positions and directions only
    ro, rd = rays_o.detach(), rays_d.detach()
    t1, t2 = scene_near_far(ro, rd, center, half, NEAR_DISTANCE)
    m = march_rays_train_flat(ro, rd, t1, t2, state["occ"], rcfg.march(cfg),
                              noise, budget_per_ray=rcfg.budget_per_ray)
    rid = m["ray_id"].long()
    d = rays_d[rid]
    xyz = fma32(m["ts"][:, None], d, rays_o[rid])
    if forward_takes_ray_id:
        sigmas, rgbs, extras = _fwd_out(forward_fn(xyz, d,
                                                   ray_id=m["ray_id"]))
    else:
        sigmas, rgbs, extras = _fwd_out(forward_fn(xyz, d))
    out = composite_train_flat(
        sigmas, rgbs, m["deltas"], m["ts"], m["ray_id"], m["offsets"],
        m["cap"], m["valid"], T_threshold=rcfg.T_threshold,
    )
    rgb_bg = background_color(rcfg, gen, dev)
    out["rgb"] = out["rgb"] + rgb_bg * (1.0 - out["opacity"])[:, None]
    out.update(
        ts=m["ts"], deltas=m["deltas"], valid=m["valid"],
        ray_id=m["ray_id"], offsets=m["offsets"], cap=m["cap"],
        n_samples=m["n_samples"], rm_samples=m["total"],
        budget_util=m["total"].to(torch.float32) / m["ts"].shape[0],
        total_samples=out["vr_samples"].sum(),
    )
    if extras is not None:
        out["gate_results"] = extras
    return out


@torch.no_grad()
def render_test(
    params: dict | None,
    state: dict,
    cfg: NGPConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    rcfg: RenderConfig,
    forward_fn=None,
    forward_takes_ray_id: bool = False,
) -> dict:
    """Test-time render of (N, 3) rays: per loop iteration the alive rays'
    kept samples compact into one (N * test_budget_per_ray,) buffer; a
    truncated ray resumes at its march cursor, and a ray retires when its
    transmittance falls below T_threshold, its window is exhausted, or it
    has consumed max_samples samples.

    `forward_fn(x, d)` overrides the field (its third item, if any, is
    dropped); with `forward_takes_ray_id` it is called as forward_fn(x,
    d, ray_id=...), each sample's ray, as in render_train; by default
    the field's, on a brick3 table packed once per call. Returns rgb (N,
    3), depth (N,), opacity (N,), total_samples and iterations (the
    loop's count)."""
    if rcfg.test_layout != "flat":
        raise NotImplementedError(DENSE_LAYOUT)
    if forward_fn is None:
        packed = pack_table(params["hash_table"], cfg)
        forward_fn = lambda x, d: ngp_forward(params, state, cfg, x, d,
                                              packed=packed)
    N = rays_o.shape[0]
    dev = rays_o.device
    center, half = scene_center_half(state)
    t1, t2 = scene_near_far(rays_o, rays_d, center, half, NEAR_DISTANCE)
    mcfg = rcfg.march(cfg)
    # rays retire on their consumed samples; max_iters is the reference's
    # safety valve, sized from the least progress an iteration makes
    max_iters = min(
        N * (rcfg.max_samples
             + int(math.ceil(mcfg.k_candidates / rcfg.test_k_block))),
        2**31 - 2,
    )
    acc = {
        "opacity": torch.zeros(N, device=dev),
        "depth": torch.zeros(N, device=dev),
        "rgb": torch.zeros((N, 3), device=dev),
        "transmittance": torch.ones(N, device=dev),
        "alive": t1 >= 0,
    }
    cursor = t1
    samples_done = torch.zeros(N, dtype=torch.int32, device=dev)
    total_samples = torch.zeros((), dtype=torch.int64, device=dev)
    i = 0
    while i < max_iters:
        if not bool((acc["alive"] & (cursor < t2)).any()):
            break
        m = march_rays_test_flat(
            rays_o, rays_d, cursor, t2, state["occ"], mcfg, acc["alive"],
            k_block=rcfg.test_k_block, cap_per_ray=rcfg.test_block_samples,
            budget_per_ray=rcfg.test_budget_per_ray,
        )
        rid = m["ray_id"].long()
        d = rays_d[rid]
        xyz = fma32(m["ts"][:, None], d, rays_o[rid])
        if forward_takes_ray_id:
            sigmas, rgbs, _ = _fwd_out(forward_fn(xyz, d,
                                                  ray_id=m["ray_id"]))
        else:
            sigmas, rgbs, _ = _fwd_out(forward_fn(xyz, d))
        acc = composite_test_flat(
            sigmas, rgbs, m["deltas"], m["ts"], m["ray_id"], m["offsets"],
            m["cap"], m["valid"], acc, rcfg.T_threshold,
        )
        samples_done = samples_done + m["consumed"]
        acc["alive"] = acc["alive"] & (samples_done < rcfg.max_samples)
        cursor = m["new_cursor"]
        total_samples = total_samples + m["consumed"].sum()
        i += 1
    rgb_bg = background_color(rcfg, None, dev)
    return {
        "rgb": acc["rgb"] + rgb_bg * (1.0 - acc["opacity"])[:, None],
        "depth": acc["depth"],
        "opacity": acc["opacity"],
        "total_samples": total_samples,
        "iterations": i,
    }
