"""Rad-NeRF MoE render, training and test time (twin of
radnerf_tpu/render/ml_render.py), and the chunked camera render of the
validation loop (MoE or single field).

Gate the rays, render the K sub-NeRFs, gate-compose. With a shared
encoder, union sampling and the flat layout, the rays are marched ONCE
against the union of the experts' occupancy grids and hash-encoded ONCE;
each expert masks sigma to its own membership (a non-member sample has
alpha 0, as if never marched). Otherwise, with a shared encoder (the
dense layout, or no union sampling), each expert marches its own grid
(with the start jitter shifted by k/K) and the K sample sets share one
encode; with one hash table per expert (shared_encoder=False), each
expert renders as a single field. Test time loops, each expert keeping
its own resumable compositing carry (the union render on the flat test
layout; each expert's single-field render otherwise); the reference's
`lax.while_loop` is a Python loop whose condition is read back from the
device once per iteration.
"""

from __future__ import annotations

import math

import torch

from ..models.gates import apply_ray_gate
from ..models.mlp import apply_mlp, slice_stacked
from ..models.mngp import (
    MNGPConfig, _encode, expert_forward_fn, expert_tables, pack_for_encode,
)
from ..models.ngp import scene_center_half
from ..ops.compositing import (
    composite_test_flat, composite_train, composite_train_flat,
)
from ..ops.fma import fma32
from ..ops.intersection import scene_near_far
from ..ops.marching import (
    march_rays_test_flat, march_rays_train, march_rays_train_flat,
    march_rays_union_flat, occupancy_lookup,
)
from ..ops.sh import sh_encode_dir
from ..ops.trunc_exp import trunc_exp
from ..utils import trace
from .render import (
    NEAR_DISTANCE, RenderConfig, background_color, render_test,
    render_train,
)


def _stack_results(results: list) -> dict:
    """Per-expert result dicts stacked on a leading (K, ...) axis."""
    return {k: torch.stack([r[k] for r in results]) for k in results[0]}


def _gate_input(rays_o, rays_d, imgs_d, gate_type: str) -> torch.Tensor:
    """'ray': origin ‖ direction; 'image': origin ‖ mean image direction."""
    if gate_type == "image":
        return torch.cat([rays_o, imgs_d], dim=1)
    return torch.cat([rays_o, rays_d], dim=1)


def _expert_samples_union_flat(
    params, state, cfg: MNGPConfig, rays_o, rays_d, rcfg: RenderConfig,
    noise: torch.Tensor, gen: torch.Generator | None = None,
) -> dict:
    """Union-of-experts training render: ONE march and ONE hash encode for
    all K experts, then per-expert MLPs and compositing of the shared
    buffer with sigma masked to each expert's membership (identical to
    each expert's own march, up to the union budgeting of
    march_rays_union_flat). `noise` (N,) is the start jitter in [0, 1);
    `gen` draws the random backgrounds (rcfg.random_bg)."""
    K = cfg.n_experts
    dev = rays_o.device
    with trace.span("render.march"):
        center, half = scene_center_half(state)
        # the march is not differentiated: its ts and deltas are the
        # reference's stop_gradient outputs, so rays that carry a gradient
        # (--optimize_ext) reach the loss through the positions, the SH
        # directions and the gate only
        ro, rd = rays_o.detach(), rays_d.detach()
        t1, t2 = scene_near_far(ro, rd, center, half, NEAR_DISTANCE)
        mcfg = rcfg.march(cfg)
        m, member = march_rays_union_flat(
            ro, rd, t1, t2, state["occ"], mcfg, noise,
            budget_per_ray=max(1, round(
                rcfg.budget_per_ray * (rcfg.union_budget_factor or K))),
            cap_scale=K,   # the per-ray cap stays expert-equivalent
        )
        rid = m["ray_id"].long()
        xyz = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])  # (B, 3)

    feat = _encode(params, state, cfg, xyz)                      # ONCE
    with trace.span("render.mlp"):
        h = apply_mlp(params["geo"], feat, compute_dtype=cfg.cdtype)
        sigmas = torch.where(member, trunc_exp(h[..., 0]), 0.0)
        d_enc_ray = sh_encode_dir(rays_d, cfg.sh_degree).to(cfg.cdtype)
        rgb_in = torch.cat(
            [d_enc_ray[rid][None].expand(K, -1, -1), h[..., 1:]], dim=-1
        )
        rgbs = apply_mlp(
            params["rgb"], rgb_in, out_act=cfg.rgb_act.lower(),
            compute_dtype=cfg.cdtype,
        ).to(torch.float32)                                   # (K, B, 3)
    with trace.span("render.composite"):
        out = composite_train_flat(
            sigmas, rgbs, m["deltas"], m["ts"], m["ray_id"], m["offsets"],
            m["cap"], member, T_threshold=rcfg.T_threshold,
        )
        bgs = torch.stack([background_color(rcfg, gen, dev)
                           for _ in range(K)])
    B = m["ts"].shape[0]

    def rep(a):  # shared union arrays -> per-expert (K, ...) interface
        return a[None].expand((K,) + a.shape)

    return {
        "rgb": out["rgb"] + bgs[:, None, :] * (1.0 - out["opacity"][..., None]),
        "depth": out["depth"],
        "opacity": out["opacity"],
        "ws": out["ws"],
        "ts": rep(m["ts"]),
        "deltas": rep(m["deltas"]),
        "valid": member,
        "ray_id": rep(m["ray_id"]),
        "offsets": rep(m["offsets"]),
        "cap": rep(m["cap"]),
        "n_samples": rep(m["n_samples"]),
        "rm_samples": member.sum(dtype=torch.int32),
        "budget_util": m["total"].to(torch.float32) / B,
        "total_samples": out["vr_samples"].sum(),
    }


def _expert_samples_per_expert(
    params, state, cfg: MNGPConfig, rays_o, rays_d, rcfg: RenderConfig,
    noises: torch.Tensor, gen: torch.Generator | None = None,
) -> dict:
    """Per-expert training render with a shared encoder: each expert
    marches its own grid (noises[k] its start jitter) on rcfg.layout,
    then ONE hash encode of the K sample sets (flat: K x B samples;
    dense: K x N x S slots, padding included), per-expert MLPs and
    compositing, and one background per expert."""
    K = cfg.n_experts
    dev = rays_o.device
    with trace.span("render.march"):
        center, half = scene_center_half(state)
        ro, rd = rays_o.detach(), rays_d.detach()  # as in the union render
        t1, t2 = scene_near_far(ro, rd, center, half, NEAR_DISTANCE)
        mcfg = rcfg.march(cfg)
        dense = rcfg.layout == "dense"
        d_enc_ray = sh_encode_dir(rays_d, cfg.sh_degree).to(cfg.cdtype)
        if dense:
            m = _stack_results([
                march_rays_train(ro, rd, t1, t2, state["occ"][k], mcfg,
                                 noises[k]) for k in range(K)])  # (K, N, S)
            N, S = m["ts"].shape[1:]
            P = N * S
            xyz = fma32(m["ts"][..., None], rays_d[None, :, None, :],
                        rays_o[None, :, None, :]).reshape(-1, 3)
            d_enc = d_enc_ray[None, :, None, :].expand(
                K, N, S, d_enc_ray.shape[-1]).reshape(K, P, -1)
        else:
            m = _stack_results([
                march_rays_train_flat(ro, rd, t1, t2, state["occ"][k], mcfg,
                                      noises[k],
                                      budget_per_ray=rcfg.budget_per_ray)
                for k in range(K)])                     # (K, B) / (K, N)
            rid = m["ray_id"].reshape(-1).long()
            xyz = fma32(m["ts"].reshape(-1)[:, None], rays_d[rid],
                        rays_o[rid])                    # (K*B, 3)
            P = m["ts"].shape[1]
            d_enc = d_enc_ray[rid].reshape(K, P, -1)

    feat = _encode(params, state, cfg, xyz).reshape(K, P, -1)    # ONCE
    with trace.span("render.mlp"):
        h = apply_mlp(params["geo"], feat, compute_dtype=cfg.cdtype)
        rgbs = apply_mlp(
            params["rgb"], torch.cat([d_enc, h[..., 1:]], dim=-1),
            out_act=cfg.rgb_act.lower(), compute_dtype=cfg.cdtype,
        ).to(torch.float32)                                     # (K, P, 3)
        sigmas = trunc_exp(h[..., 0])
    with trace.span("render.composite"):
        if dense:
            out = composite_train(
                sigmas.reshape(K, N, S), rgbs.reshape(K, N, S, 3),
                m["deltas"], m["ts"], m["valid"],
                T_threshold=rcfg.T_threshold)
            extra = {"rm_samples": m["n_samples"].sum()}
        else:
            out = _stack_results([
                composite_train_flat(
                    sigmas[k], rgbs[k], m["deltas"][k], m["ts"][k],
                    m["ray_id"][k], m["offsets"][k], m["cap"][k],
                    m["valid"][k], T_threshold=rcfg.T_threshold)
                for k in range(K)])
            extra = {k: m[k] for k in ("ray_id", "offsets", "cap")}
            extra["rm_samples"] = m["total"].sum()
        bgs = torch.stack([background_color(rcfg, gen, dev)
                           for _ in range(K)])
    return {
        "rgb": out["rgb"] + bgs[:, None, :] * (1.0 - out["opacity"][..., None]),
        "depth": out["depth"],
        "opacity": out["opacity"],
        "ws": out["ws"],
        **{k: m[k] for k in ("ts", "deltas", "valid", "n_samples")},
        "total_samples": out["vr_samples"].sum(),
        **extra,
    }


def ml_render_train(
    params: dict,
    state: dict,
    cfg: MNGPConfig,
    gate_params: dict,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    imgs_d: torch.Tensor,
    rcfg: RenderConfig,
    gate_type: str = "ray",
    noise: torch.Tensor | None = None,
    gen: torch.Generator | None = None,
) -> dict:
    """Training-time MoE render of (N, 3) rays, differentiable in params
    and gate_params. `noise` (N,) is the per-ray start jitter in [0, 1):
    the union render shares it, the per-expert renders shift it to
    mod(noise + k/K, 1) for expert k; without it the jitter is drawn from
    `gen` (K draws a ray on the per-expert renders), which also draws the
    random backgrounds. Union sampling applies on the flat layout only;
    on the dense one each expert marches its own grid.

    Returns rgb (N, 3), depth (N, K), opacity (N,), gating_code (N, K),
    gating_importance (K,), independent_rgbs (K, N, 3), the per-expert
    sample buffers (flat: ws, deltas, ts, valid, ray_id, offsets, cap,
    each (K, ...); dense: ws, deltas, ts, valid (K, N, S)), rm_samples,
    budget_util (the union buffer's share used; the unshared flat
    renders' mean; 0 where no render measures one, as in the reference)
    and total_samples."""
    K, N = cfg.n_experts, rays_o.shape[0]
    dev = rays_o.device
    with trace.span("render.gate"):
        gate, importance, _ = apply_ray_gate(
            gate_params, _gate_input(rays_o, rays_d, imgs_d, gate_type),
            compute_dtype=cfg.cdtype,
        )
    union = (cfg.shared_encoder and rcfg.union_sampling
             and rcfg.layout == "flat")
    if noise is None:
        noise = torch.rand((N,) if union else (K, N), generator=gen,
                           device=dev)
    if noise.dim() == 1 and not union:
        # per-expert jitter as cyclic shifts of the per-ray uniform
        shift = torch.arange(K, dtype=torch.float32, device=dev)[:, None] / K
        noise = torch.remainder(noise[None, :] + shift, 1.0)
    if union:
        res = _expert_samples_union_flat(params, state, cfg, rays_o, rays_d,
                                         rcfg, noise, gen)
    elif cfg.shared_encoder:
        res = _expert_samples_per_expert(params, state, cfg, rays_o,
                                         rays_d, rcfg, noise, gen)
    else:
        # unshared_MNGP: K single-field renders, each with its own table
        res = _stack_results([
            render_train(
                None, {**state, "occ": state["occ"][k]}, cfg, rays_o,
                rays_d, rcfg,
                forward_fn=expert_forward_fn(
                    table, slice_stacked(params["geo"], k),
                    slice_stacked(params["rgb"], k), state, cfg),
                noise=noise[k], gen=gen)
            for k, table in enumerate(expert_tables(params, cfg))])
    return {
        "rgb": torch.einsum("nk,knc->nc", gate, res["rgb"]),
        "depth": res["depth"].T,
        "opacity": torch.einsum("nk,kn->n", gate, res["opacity"]),
        "gating_code": gate,
        "gating_importance": importance,
        "independent_rgbs": res["rgb"],
        **{k: res[k] for k in ("ws", "deltas", "ts", "valid", "ray_id",
                               "offsets", "cap") if k in res},
        "rm_samples": res["rm_samples"].sum(),
        "budget_util": (res["budget_util"].mean() if "budget_util" in res
                        else torch.zeros((), device=dev)),
        "total_samples": res["total_samples"].sum(),
    }


def _ml_test_union_flat(
    params, state, cfg: MNGPConfig, rays_o, rays_d, rcfg: RenderConfig
) -> dict:
    """Union-of-experts test render: per iteration ONE flat march against
    the union grid and ONE shared hash encode serve all K experts; the
    march cursor is shared (an expert only ever skips non-member samples,
    alpha 0). Returns rgb (K, N, 3), depth and opacity (K, N),
    total_samples, and the loop's iteration count."""
    K, N = cfg.n_experts, rays_o.shape[0]
    dev = rays_o.device
    with trace.span("render.march"):
        center, half = scene_center_half(state)
        t1, t2 = scene_near_far(rays_o, rays_d, center, half, NEAR_DISTANCE)
        mcfg = rcfg.march(cfg)
        occ_union = state["occ"].any(dim=0).contiguous()
    with trace.span("render.encode"):
        d_enc_ray = sh_encode_dir(rays_d, cfg.sh_degree).to(cfg.cdtype)
        packed = pack_for_encode(params, cfg)           # once per call
    # per-ray samples_done retirement bounds real progress; max_iters is
    # the reference's safety valve
    max_iters = min(
        N * (rcfg.max_samples
             + int(math.ceil(mcfg.k_candidates / rcfg.test_k_block))),
        2**31 - 2,
    )
    acc = {
        "opacity": torch.zeros((K, N), device=dev),
        "depth": torch.zeros((K, N), device=dev),
        "rgb": torch.zeros((K, N, 3), device=dev),
        "transmittance": torch.ones((K, N), device=dev),
        "alive": (t1 >= 0)[None].expand(K, N),
    }
    cursor = t1
    samples_done = torch.zeros(N, dtype=torch.int32, device=dev)
    total_samples = torch.zeros((), dtype=torch.int64, device=dev)
    i = 0
    while i < max_iters:
        union_alive = acc["alive"].any(dim=0)
        with trace.span("sync.test_alive"):
            more = bool((union_alive & (cursor < t2)).any())
        if not more:
            break
        with trace.span("test.iteration"):
            with trace.span("render.march"):
                m = march_rays_test_flat(
                    rays_o, rays_d, cursor, t2, occ_union, mcfg, union_alive,
                    k_block=rcfg.test_k_block,
                    cap_per_ray=rcfg.test_block_samples,
                    budget_per_ray=rcfg.test_budget_per_ray,
                )
                rid = m["ray_id"].long()
                xyz = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])
                member = torch.stack([
                    occupancy_lookup(xyz, m["deltas"], state["occ"][k], mcfg)
                    for k in range(K)
                ]) & m["valid"][None, :]

            feat = _encode(params, state, cfg, xyz, packed=packed)  # ONCE
            with trace.span("render.mlp"):
                h = apply_mlp(params["geo"], feat, compute_dtype=cfg.cdtype)
                sigmas = torch.where(member, trunc_exp(h[..., 0]), 0.0)
                rgb_in = torch.cat(
                    [d_enc_ray[rid][None].expand(K, -1, -1), h[..., 1:]],
                    dim=-1)
                rgbs = apply_mlp(
                    params["rgb"], rgb_in, out_act=cfg.rgb_act.lower(),
                    compute_dtype=cfg.cdtype,
                ).to(torch.float32)                          # (K, B, 3)

            with trace.span("render.composite"):
                acc = composite_test_flat(
                    sigmas, rgbs, m["deltas"], m["ts"], m["ray_id"],
                    m["offsets"], m["cap"], member, acc, rcfg.T_threshold,
                )
                samples_done = samples_done + m["consumed"]
                acc["alive"] = acc["alive"] & (
                    samples_done < rcfg.max_samples)[None, :]
                cursor = m["new_cursor"]
                total_samples = total_samples + m["consumed"].sum()
            i += 1

    rgb_bg = background_color(rcfg, None, dev)
    return {
        "rgb": acc["rgb"] + rgb_bg * (1.0 - acc["opacity"][..., None]),
        "depth": acc["depth"],
        "opacity": acc["opacity"],
        "total_samples": total_samples,
        "iterations": i,
    }


def ml_render_test(
    params: dict,
    state: dict,
    cfg: MNGPConfig,
    gate_params: dict,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    imgs_d: torch.Tensor,
    rcfg: RenderConfig,
    gate_type: str = "ray",
) -> dict:
    """Test-time MoE render of (N, 3) rays: the union render (shared
    encoder, union sampling, the flat test layout), else K single-field
    renders (render_test on rcfg.test_layout), one per expert, each on
    its own grid, with the shared table or its own, packed once per
    call. Returns rgb (N, 3), depth (N, K), opacity (N,),
    gating_code (N, K), gating_importance (K,), independent_rgbs (K, N,
    3), total_samples, and iterations (the loops' count, summed over the
    experts' loops)."""
    with torch.no_grad():
        with trace.span("render.gate"):
            gate, importance, _ = apply_ray_gate(
                gate_params, _gate_input(rays_o, rays_d, imgs_d, gate_type),
                compute_dtype=cfg.cdtype,
            )
        if (cfg.shared_encoder and rcfg.union_sampling
                and rcfg.test_layout == "flat"):
            res = _ml_test_union_flat(params, state, cfg, rays_o, rays_d,
                                      rcfg)
        else:
            packed = pack_for_encode(params, cfg)
            if cfg.shared_encoder:
                packed = [packed] * cfg.n_experts
            outs = [
                render_test(
                    None, {**state, "occ": state["occ"][k]}, cfg, rays_o,
                    rays_d, rcfg,
                    forward_fn=expert_forward_fn(
                        table, slice_stacked(params["geo"], k),
                        slice_stacked(params["rgb"], k), state, cfg,
                        packed=packed[k]))
                for k, table in enumerate(expert_tables(params, cfg))]
            res = {**_stack_results([{k: o[k] for k in (
                "rgb", "depth", "opacity", "total_samples")} for o in outs]),
                "iterations": sum(o["iterations"] for o in outs)}
    return {
        "rgb": torch.einsum("nk,knc->nc", gate, res["rgb"]),
        "depth": res["depth"].T,
        "opacity": torch.einsum("nk,kn->n", gate, res["opacity"]),
        "gating_code": gate,
        "gating_importance": importance,
        "independent_rgbs": res["rgb"],
        "total_samples": res["total_samples"].sum(),
        "iterations": res["iterations"],
    }


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """(N, 3) camera-frame directions x (N, 3, 4) or (3, 4) camera-to-world
    -> (rays_o, rays_d), each (N, 3); directions are not normalized."""
    c2w = c2w.expand(directions.shape[0], 3, 4)
    # the 3-term dot products written out, ((d0 r0 + d1 r1) + d2 r2), as
    # the CPU's einsum sums them: the card's batched matmul rounds them
    # otherwise, and a ray one ulp apart moves its samples' encode
    d = directions[:, None, :]
    rays_d = (d[..., 0] * c2w[..., 0] + d[..., 1] * c2w[..., 1]
              + d[..., 2] * c2w[..., 2])
    return c2w[..., 3], rays_d


def render_rays_chunked(
    params: dict,
    state: dict,
    cfg,
    gate_params: dict | None,
    directions: torch.Tensor,
    pose: torch.Tensor,
    rcfg: RenderConfig,
    chunk: int = 4096,
    gate_type: str = "ray",
    mean_dir: torch.Tensor | None = None,
    render=None,
) -> dict:
    """Render one camera, as the trainer's validation loop does: chunks of
    `chunk` rays (the last one padded by repeating its final direction),
    rays from `pose` (3, 4). With a gate, the MoE render (ml_render_test)
    and the gated consensus depth sum_k depth_k * gate_k; with
    gate_params None, the single field (render_test) and its own depth;
    `render(rays_o, rays_d) -> {rgb, depth, opacity, total_samples,
    iterations}` overrides both (the baselines' renders).

    Returns rgb (P, 3), depth (P,), opacity (P,) for the P directions,
    plus total_samples and iterations summed over chunks."""
    n_pix = directions.shape[0]
    dev = directions.device
    if mean_dir is None:
        mean_dir = torch.zeros(3, device=dev)
    rgb, depth, opacity = [], [], []
    total_samples, iterations = 0, 0
    for c0 in range(0, n_pix, chunk):
        with trace.span("test.chunk"):
            c1 = min(c0 + chunk, n_pix)
            dirs = directions[c0:c1]
            pad = chunk - (c1 - c0)
            if pad:
                dirs = torch.cat([dirs, dirs[-1:].expand(pad, 3)])
            poses_c = pose.expand(chunk, 3, 4)
            rays_o, rays_d = get_rays(dirs, poses_c)
            rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
            if render is not None:
                out = render(rays_o, rays_d)
                d = out["depth"]
            elif gate_params is None:
                out = render_test(params, state, cfg, rays_o, rays_d, rcfg)
                d = out["depth"]
            else:
                imgs_d = get_rays(mean_dir.expand(chunk, 3), poses_c)[1]
                out = ml_render_test(params, state, cfg, gate_params, rays_o,
                                     rays_d, imgs_d, rcfg, gate_type)
                d = (out["depth"] * out["gating_code"]).sum(dim=1)
            n = c1 - c0
            rgb.append(out["rgb"][:n])
            depth.append(d[:n])
            opacity.append(out["opacity"][:n])
            with trace.span("sync.total_samples"):
                total_samples += int(out["total_samples"])
            iterations += out["iterations"]
    return {
        "rgb": torch.cat(rgb),
        "depth": torch.cat(depth),
        "opacity": torch.cat(opacity),
        "total_samples": total_samples,
        "iterations": iterations,
    }
