"""Single-field rendering, training and test time (twin of
radnerf_tpu/render/render.py), and the render configuration.

Training: AABB intersection, the march of the field's occupancy grid, the
field on every sample slot, compositing, the background; on the flat
layout (a static-CSR buffer of the marched samples) or the dense one
((N, S) rows of slots, padding included). Test time: the reference's
`lax.while_loop` of march blocks (flat or dense) is a Python loop whose
condition is read back from the device once per iteration; each ray keeps
a resumable compositing carry. `render_test_compacted` runs that loop a
few iterations at a time and gathers the rays still alive into a smaller
power-of-two batch between phases.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from ..models.ngp import NGPConfig, ngp_forward, pack_table, scene_center_half
from ..ops.compositing import (
    composite_test_block, composite_test_flat, composite_train,
    composite_train_flat,
)
from ..ops.fma import fma32
from ..ops.intersection import scene_near_far
from ..ops.marching import (
    MarchConfig, march_rays_test_block, march_rays_test_flat,
    march_rays_train, march_rays_train_flat,
)

MAX_SAMPLES = 1024
NEAR_DISTANCE = 0.01


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render knobs. Test time: test_layout "flat" (the alive rays'
    samples compacted into an N * test_budget_per_ray buffer an
    iteration) or "dense" ((N, test_block_samples) rows); the defaults
    (128 / 24 / 512 at chunk 4096) are the reference's joint optimum for
    the flat layout. Training: layout "flat", a static budget B = N *
    budget_per_ray, scaled for the MoE union stream by
    union_budget_factor (0.0 = the number of experts), or "dense", (N,
    samples_per_ray) rows."""

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

    Returns rgb (N, 3), depth (N,), opacity (N,), the sample buffers
    (flat: ws, ts, deltas, valid, ray_id (B,) and offsets, cap (N,);
    dense: ws, ts, deltas, valid (N, S)), n_samples (N,), rm_samples,
    total_samples and vr_samples; the flat layout also budget_util (the
    share of the B slots used). On the dense layout the field sees every
    slot, ray-major, and is never given ray_id (a closure that needs
    each sample's ray repeats its per-ray values S times)."""
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
    mcfg = rcfg.march(cfg)
    if rcfg.layout == "dense":
        m = march_rays_train(ro, rd, t1, t2, state["occ"], mcfg, noise)
        N, S = m["ts"].shape
        xyz = fma32(m["ts"][..., None], rays_d[:, None, :],
                    rays_o[:, None, :])
        dirs = rays_d[:, None, :].expand(N, S, 3)
        sigmas, rgbs, extras = _fwd_out(forward_fn(xyz.reshape(-1, 3),
                                                   dirs.reshape(-1, 3)))
        out = composite_train(
            sigmas.reshape(N, S), rgbs.reshape(N, S, 3), m["deltas"],
            m["ts"], m["valid"], rcfg.T_threshold)
        out.update(
            ts=m["ts"], deltas=m["deltas"], valid=m["valid"],
            n_samples=m["n_samples"], rm_samples=m["n_samples"].sum(),
            total_samples=out["vr_samples"].sum(),
        )
    else:
        m = march_rays_train_flat(ro, rd, t1, t2, state["occ"], mcfg,
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
        out.update(
            ts=m["ts"], deltas=m["deltas"], valid=m["valid"],
            ray_id=m["ray_id"], offsets=m["offsets"], cap=m["cap"],
            n_samples=m["n_samples"], rm_samples=m["total"],
            budget_util=m["total"].to(torch.float32) / m["ts"].shape[0],
            total_samples=out["vr_samples"].sum(),
        )
    rgb_bg = background_color(rcfg, gen, dev)
    out["rgb"] = out["rgb"] + rgb_bg * (1.0 - out["opacity"])[:, None]
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
    carry_in: dict | None = None,
    n_iters: int | None = None,
    return_carry: bool = False,
):
    """Test-time render of (N, 3) rays, a loop of march blocks, each ray
    with a resumable compositing carry; a ray retires when its
    transmittance falls below T_threshold or its window is exhausted.

    test_layout "flat": per iteration the alive rays' kept samples
    compact into one (N * test_budget_per_ray,) buffer; a truncated ray
    resumes at its march cursor, and a ray also retires once it has
    consumed max_samples samples. test_layout "dense": per iteration every
    ray marches its next test_k_block candidates into (N,
    test_block_samples) rows, at most ceil(max_samples /
    test_block_samples) iterations.

    `forward_fn(x, d)` overrides the field (its third item, if any, is
    dropped); with `forward_takes_ray_id` the flat layout calls it as
    forward_fn(x, d, ray_id=...), each sample's ray (the dense layout
    never does, as in render_train); by default the field's, on a brick3
    table packed once per call.
    `carry_in` (a carry this function returned) resumes a render,
    `n_iters` caps this call's iterations, and with `return_carry` the
    result is (out, carry, done (N,) bool): the phases of
    render_test_compacted.

    Returns rgb (N, 3), depth (N,), opacity (N,), total_samples and
    iterations (the loop's count)."""
    if forward_fn is None:
        packed = pack_table(params["hash_table"], cfg)
        forward_fn = lambda x, d: ngp_forward(params, state, cfg, x, d,
                                              packed=packed)
    occ = state["occ"]
    dense = rcfg.test_layout == "dense"
    N = rays_o.shape[0]
    dev = rays_o.device
    center, half = scene_center_half(state)
    t1, t2 = scene_near_far(rays_o, rays_d, center, half, NEAR_DISTANCE)
    mcfg = rcfg.march(cfg)
    S = rcfg.test_block_samples
    if dense:
        max_iters = int(math.ceil(rcfg.max_samples / S))
    else:
        # rays retire on their consumed samples; max_iters is the
        # reference's safety valve, sized from the least progress an
        # iteration makes
        max_iters = min(
            N * (rcfg.max_samples
                 + int(math.ceil(mcfg.k_candidates / rcfg.test_k_block))),
            2**31 - 2,
        )
    if n_iters is not None:
        max_iters = min(max_iters, n_iters)
    if carry_in is None:
        acc = {
            "opacity": torch.zeros(N, device=dev),
            "depth": torch.zeros(N, device=dev),
            "rgb": torch.zeros((N, 3), device=dev),
            "transmittance": torch.ones(N, device=dev),
            "alive": t1 >= 0,
        }
        carry = {"cursor": t1, "acc": acc,
                 "total_samples": torch.zeros((), dtype=torch.int64,
                                              device=dev)}
        if not dense:
            carry["samples_done"] = torch.zeros(N, dtype=torch.int32,
                                                device=dev)
    else:
        carry = dict(carry_in)
    acc, cursor = carry["acc"], carry["cursor"]
    total_samples = carry["total_samples"]
    i = 0
    while i < max_iters:
        if not bool((acc["alive"] & (cursor < t2)).any()):
            break
        if dense:
            blk = march_rays_test_block(
                rays_o, rays_d, cursor, t2, occ, mcfg, n_samples=S,
                k_block=rcfg.test_k_block)
            xyz = fma32(blk["ts"][..., None], rays_d[:, None, :],
                        rays_o[:, None, :])
            dirs = rays_d[:, None, :].expand(N, S, 3)
            sigmas, rgbs, _ = _fwd_out(forward_fn(xyz.reshape(-1, 3),
                                                  dirs.reshape(-1, 3)))
            total_samples = total_samples + torch.where(
                acc["alive"], blk["n_eff"], 0).sum()
            acc = composite_test_block(
                sigmas.reshape(N, S), rgbs.reshape(N, S, 3), blk["deltas"],
                blk["ts"], blk["valid"], acc, rcfg.T_threshold)
            cursor = blk["new_cursor"]
        else:
            m = march_rays_test_flat(
                rays_o, rays_d, cursor, t2, occ, mcfg, acc["alive"],
                k_block=rcfg.test_k_block, cap_per_ray=S,
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
                sigmas, rgbs, m["deltas"], m["ts"], m["ray_id"],
                m["offsets"], m["cap"], m["valid"], acc, rcfg.T_threshold,
            )
            samples_done = carry["samples_done"] + m["consumed"]
            carry["samples_done"] = samples_done
            acc["alive"] = acc["alive"] & (samples_done < rcfg.max_samples)
            cursor = m["new_cursor"]
            total_samples = total_samples + m["consumed"].sum()
        i += 1
    rgb_bg = background_color(rcfg, None, dev)
    out = {
        "rgb": acc["rgb"] + rgb_bg * (1.0 - acc["opacity"])[:, None],
        "depth": acc["depth"],
        "opacity": acc["opacity"],
        "total_samples": total_samples,
        "iterations": i,
    }
    if return_carry:
        carry.update(acc=acc, cursor=cursor, total_samples=total_samples)
        return out, carry, ~(acc["alive"] & (cursor < t2))
    return out


def _bucket(n: int) -> int:
    """The power-of-two batch, at least 128, that holds n rays."""
    return max(128, 1 << (n - 1).bit_length())


@torch.no_grad()
def render_test_compacted(
    params: dict | None,
    state: dict,
    cfg: NGPConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    rcfg: RenderConfig,
    forward_fn=None,
    phase_iters: int = 4,
) -> dict:
    """render_test with alive-ray compaction between phases: `phase_iters`
    loop iterations at a time, after which the rays still alive are
    gathered into the next power-of-two batch (at least 128 rays), their
    carries with them, so dead rays stop costing field evaluations. The
    per-ray math is render_test's; only the lanes change. Pad lanes take
    a ray that misses the scene box (index N: past the box's +x face,
    pointing +x), dead from the start. The rays and outputs stay on the
    device; each phase reads back its done mask only. A run that has not
    finished after 4x the expected phases (at least 64) warns and returns
    the partly composited rays.

    `forward_fn(x, d)` overrides the field (default: the field's, on a
    table packed once for every phase). Returns rgb (N, 3), depth (N,),
    opacity (N,), total_samples and iterations (summed over phases)."""
    if forward_fn is None:
        packed = pack_table(params["hash_table"], cfg)
        forward_fn = lambda x, d: ngp_forward(params, state, cfg, x, d,
                                              packed=packed)
    N = rays_o.shape[0]
    dev = rays_o.device
    S = rcfg.test_block_samples
    if rcfg.test_layout == "flat":
        # the flat loop guarantees only test_budget_per_ray samples of
        # progress per alive ray an iteration: a safety cap only
        total_phases = int(math.ceil(
            (rcfg.max_samples / max(rcfg.test_budget_per_ray, 1) + 8)
            / phase_iters)) * 8
    else:
        total_phases = int(math.ceil(math.ceil(rcfg.max_samples / S)
                                     / phase_iters))
    out_acc = {
        "rgb": torch.zeros((N, 3), device=dev),
        "depth": torch.zeros(N, device=dev),
        "opacity": torch.zeros(N, device=dev),
    }
    total_samples = torch.zeros((), dtype=torch.int64, device=dev)
    center, half = scene_center_half(state)
    miss_x = center[0] + 2.0 * half.max() + 1.0
    miss_o = torch.stack([miss_x, torch.zeros_like(miss_x),
                          torch.zeros_like(miss_x)]).to(torch.float32)
    miss_d = torch.tensor([1.0, 0.0, 0.0], device=dev)
    ro_ext = torch.cat([rays_o, miss_o.to(dev)[None]])
    rd_ext = torch.cat([rays_d, miss_d[None]])
    idx = torch.arange(N, device=dev)
    carry = None
    iterations = 0
    phases = 0
    hard_cap = max(4 * total_phases, 64)
    while phases < hard_cap:
        phases += 1
        n = idx.shape[0]
        pad = _bucket(n) - n
        sel = torch.cat([idx, idx.new_full((pad,), N)]) if pad else idx
        out, carry2, done = render_test(
            params, state, cfg, ro_ext[sel], rd_ext[sel], rcfg,
            forward_fn=forward_fn, carry_in=carry,
            n_iters=phase_iters, return_carry=True)
        iterations += out["iterations"]
        total_samples = total_samples + out["total_samples"]
        for k in out_acc:
            out_acc[k][idx] = out[k][:n]
        keep = torch.nonzero(~done[:n]).squeeze(1)
        if keep.shape[0] == 0:          # the phase's one host read
            idx = idx[:0]
            break
        idx = idx[keep]
        # the carry gathered down to the surviving rays, padded to the
        # next phase's batch; pad lanes are dead
        n2 = keep.shape[0]
        pad2 = _bucket(n2) - n2
        ksel = torch.cat([keep, keep[-1:].expand(pad2)]) if pad2 else keep
        acc = {k: v[ksel] for k, v in carry2["acc"].items()}
        acc["alive"] = acc["alive"] & (
            torch.arange(ksel.shape[0], device=dev) < n2)
        carry = {k: v[ksel] for k, v in carry2.items()
                 if k not in ("acc", "total_samples")}
        carry.update(acc=acc, total_samples=torch.zeros_like(total_samples))
    if idx.shape[0] > 0:
        warnings.warn(
            f"render_test_compacted: phase cap ({hard_cap}) reached with "
            f"{idx.shape[0]} rays still alive; their output is partly "
            "composited (the march did not finish)", RuntimeWarning)
    return {**out_acc, "total_samples": total_samples,
            "iterations": iterations}
