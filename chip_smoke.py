#!/usr/bin/env python3
"""Drive the PyTorch port's Rad-NeRF MoE render and training on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure is an uncaught error and a nonzero exit; there is no
CPU fallback):
  1. device: the card's name and power limit, from nvidia-smi;
  2. build: compile every CUDA kernel of the path from csrc/ (nvcc, sm_90a);
  3. kernels 1 and 2 vs their plain PyTorch versions on the card, at the
     shapes of the render's first loop iteration on a 4096-ray chunk: the
     candidate occupancy on 4096 x 512 candidates (must be equal), the
     brick3 encode on the iteration's 98,304 marched samples at L=16,
     T=2^19 (within one bf16 ulp); median times of kernel, plain version
     and library call;
  4. the slice at full width: MNGP zoo=2 (scale 0.5, T=2^19, G=128, bf16,
     brick3) from torch.Generator seed 0, expert 0 occupying a solid
     0.3-radius sphere and expert 1 its +x half, renders a 400x400 pinhole
     image from radius 1.2 through render_rays_chunked (chunk 4096,
     RenderConfig 128 / 24 / 512), timed three times (median rays/s);
     launch counts are reset just before the first render and read just
     after it; one chunk is profiled (device busy share, top
     kernels); then one 256-ray chunk is rendered again on the card and on
     the CPU (plain versions) and compared;
  5. training at full width (zoo=2, T=2^19, L=16, G=128, bf16, brick3;
     batch 8192 in 4 microbatches of 2048 rays, budget 64, lr 1e-2, cv
     1e-2, depth-mutual 5e-3) on an analytic emissive 0.3-sphere: a ray
     store of 32 cameras x 64x64 pixels whose target colours the port's
     own march and compositor render (no dataset); then all three
     kernels against their plain versions at one 2048-ray microbatch's
     shapes (the union march's 2048 x 1024 lattice candidates, its
     marched samples, the table gradient of a random output gradient),
     and the encode on one warmup grid update's 2,097,152 cells; then
     TRAIN_STEPS steps of Trainer.fit_steps (grid updates every 16 steps,
     every cell below step 256, the adaptive budget), launch counts reset
     just before and read just after; loss and PSNR at intervals, train
     rays/s (median over the steps after the first 16); the microbatch
     checks again at the trained grids and the grown budget; one step
     profiled; then one 256-ray step on the card and on the CPU (plain
     versions) from the same parameters and draws, loss and every
     gradient leaf compared;
  6. a JSON line with every kernel's check, launches, times and bound;
  7. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from radnerf_tpu_torch import kernels
from radnerf_tpu_torch.models.gates import init_ray_gate
from radnerf_tpu_torch.models.mngp import MNGPConfig, init_mngp, init_mngp_state
from radnerf_tpu_torch.models.ngp import (
    all_cell_coords, cell_world_positions, scene_center_half,
)
from radnerf_tpu_torch.ops.compositing import composite_train_flat
from radnerf_tpu_torch.ops.fma import fma32
from radnerf_tpu_torch.ops.hashgrid_brick3 import (
    _corner_terms, _encode_plain, _table_grad_plain,
    hashgrid_encode_brick3_fwd_impl, hashgrid_table_grad_brick3,
    pack_brick3_table,
)
from radnerf_tpu_torch.ops.intersection import scene_near_far
from radnerf_tpu_torch.ops.marching import (
    _lattice_candidates, _occ_flat_index, calc_dt, march_rays_test_flat,
    march_rays_union_flat, occupancy_lookup, occupancy_lookup_bricks,
    sample_lattice,
)
from radnerf_tpu_torch.parallel.step import (
    microbatched_value_and_grad, tree_leaves, tree_unflatten,
)
from radnerf_tpu_torch.render.ml_render import get_rays, render_rays_chunked
from radnerf_tpu_torch.render.render import NEAR_DISTANCE, RenderConfig
from radnerf_tpu_torch.train import trainer as tt

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32, outside the tensor cores
SIDE = 400                      # image side (pixels)
CHUNK = 4096                    # rays per ml_render_test call (--val_chunk)
CPU_RAYS = 256                  # rays of the card-vs-CPU chunk
RENDER_REPEATS = 3              # timed full renders (median reported)
# card vs CPU on the same 256 rays: the MLPs run in bf16, and cuBLAS and
# the CPU sum in different orders, so an MLP output may differ by one bf16
# ulp: rgb (a bf16 sigmoid, ulp 2^-8 on [0.5, 1)) by ~4e-3 per ulp, sigma
# = exp(bf16) by a relative 2^-8 at most; the march and the encode are
# exact (phase 3), so nothing else moves.
CPU_TOL = {"rgb": 1e-2, "opacity": 5e-3, "depth": 5e-3}
TRAIN_STEPS = 320               # 256 warmup steps, then 4 later updates
STORE_IMAGES, STORE_SIDE = 32, 64   # the ray store: 32 cameras x 64x64
# card vs CPU, one 256-ray training step: the march and the encode are
# exact on both (phase 3), the table gradient is the same f32 sum in
# another (atomic) order; the bf16 MLPs (cuBLAS vs the CPU) may round an
# output one bf16 ulp apart (2^-8 relative), which the backward carries
# into every leaf: the loss within 1%, each gradient leaf within 2% of its
# largest entry
TRAIN_CPU_LOSS_RTOL = 1e-2
TRAIN_CPU_GRAD_RTOL = 2e-2
# kernel 3 vs its plain version: the same f32 products summed by atomics
# in an order that changes from run to run: within 2 (n - 1) u sum|terms|
# per table entry (n terms, u = 2^-24)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median over `reps` launches of fn, each timed by CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(n_bytes: float, n_ops: float) -> dict:
    """Least time the card could take: the larger of bytes over HBM rate
    and float32 operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in units of the bf16 ulp of max(|a|, |b|)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    ulp = torch.where(mag > 0, ulp, 1.0)
    return float(((a - b).abs() / ulp).max())


def camera(side: int, device):
    """bench_render's pinhole camera at radius 1.2 looking at the origin:
    camera-frame directions (u, v, 1.2) and the (3, 4) camera-to-world."""
    eye = np.array([0.0, -1.2, 0.25])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    u, v = np.meshgrid((np.arange(side) + 0.5) / side - 0.5,
                       (np.arange(side) + 0.5) / side - 0.5)
    dirs = np.stack([u, v, np.full_like(u, 1.2)], -1).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pose = np.concatenate(
        [np.stack([right, down, fwd], axis=1), eye[:, None]], axis=1)
    return (torch.tensor(dirs, dtype=torch.float32, device=device),
            torch.tensor(pose, dtype=torch.float32, device=device))


def occupancy(cfg: MNGPConfig, device) -> torch.Tensor:
    """Expert 0: bench_render's solid 0.3-radius sphere; expert 1: its +x
    half, so that membership masking is exercised."""
    g = cfg.grid_size
    lin = (np.arange(g) + 0.5) / g * 2 - 1
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = (np.sqrt(xx**2 + yy**2 + zz**2) * cfg.scale) < 0.3
    occ = np.stack([sphere, sphere & (xx > 0)])[:, None]
    return torch.tensor(np.broadcast_to(
        occ, (2, cfg.cascades, g, g, g)).copy(), device=device)


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def brick3_words_needed(x: torch.Tensor, cfg) -> int:
    """Distinct packed-table words the encode of x must read (a packed
    word and a table entry share one flat index)."""
    return int(torch.unique(_corner_terms(x, cfg)[0]).numel())


def profile_call(render, label: str = f"one {CHUNK}-ray chunk") -> dict:
    """Where one call's time goes: wall time, summed device kernel time
    (kernels run on one stream, so the sum is the busy time), launch
    count, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in by_name.values())
    launches = sum(n for _, n in by_name.values())
    if not by_name:
        print("[profile] device time: not measured (no CUDA events)")
        return {}
    print(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
          f"{launches} device kernels")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, n) in top:
        print(f"[profile]   {us / 1e3:8.3f} ms {n:5d}x  {name[:90]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "kernels": launches}


def sphere_store(n_img: int, side: int, device) -> dict:
    """The ray store of the training phase: n_img cameras on a shell of
    radius 1.2 (a Fibonacci spiral), each looking at the origin through
    the same side x side pinhole directions."""
    i = np.arange(n_img) + 0.5
    z = 1.0 - 2.0 * i / n_img
    phi = np.pi * (1.0 + 5.0**0.5) * i
    eyes = 1.2 * np.stack([np.sqrt(1 - z * z) * np.cos(phi),
                           np.sqrt(1 - z * z) * np.sin(phi), z], axis=1)
    poses = []
    for eye in eyes:
        fwd = -eye / np.linalg.norm(eye)
        up = [0.0, 0.0, 1.0] if abs(fwd[2]) < 0.9 else [1.0, 0.0, 0.0]
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        poses.append(np.concatenate(
            [np.stack([right, down, fwd], axis=1), eye[:, None]], axis=1))
    u, v = np.meshgrid((np.arange(side) + 0.5) / side - 0.5,
                       (np.arange(side) + 0.5) / side - 0.5)
    dirs = np.stack([u, v, np.full_like(u, 1.2)], -1).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return {
        "poses": torch.tensor(np.stack(poses), dtype=torch.float32,
                              device=device),
        "directions": torch.tensor(dirs, dtype=torch.float32, device=device),
    }


@torch.no_grad()
def render_sphere(store: dict, cfg: MNGPConfig, chunk: int = 4096):
    """Target colours of every ray of the store: examples/smoke_e2e.py's
    emissive sphere (sigma 40 inside radius 0.3, colour (0.5 + x, 0.5 + y,
    0.5 - z) clipped), rendered by the port's union march (a grid of the
    sphere's cells, jitter 0.5) and training compositor, white
    background. Returns (n_img, n_pix, 3)."""
    dev = store["directions"].device
    g = cfg.grid_size
    lin = (torch.arange(g, device=dev) + 0.5) / g * 2 - 1
    xx, yy, zz = torch.meshgrid(lin, lin, lin, indexing="ij")
    occ = ((xx**2 + yy**2 + zz**2).sqrt() * cfg.scale < 0.32)[None, None]
    mcfg = RenderConfig(samples_per_ray=512).march(cfg)
    n_img, n_pix = store["poses"].shape[0], store["directions"].shape[0]
    out = []
    for img in range(n_img):
        for c0 in range(0, n_pix, chunk):
            rays_o, rays_d = get_rays(store["directions"][c0:c0 + chunk],
                                      store["poses"][img])
            rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
            t1, t2 = scene_near_far(rays_o, rays_d, torch.zeros(3, device=dev),
                                    torch.full((3,), cfg.scale, device=dev),
                                    NEAR_DISTANCE)
            m, member = march_rays_union_flat(
                rays_o, rays_d, t1, t2, occ.expand(1, cfg.cascades, g, g, g),
                mcfg, torch.full_like(t1, 0.5), budget_per_ray=256)
            check(int(m["total"]) < m["ts"].shape[0],
                  "target render truncated rays")
            rid = m["ray_id"].long()
            x = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])
            sigma = torch.where(x.norm(dim=1) < 0.3, 40.0, 0.0)
            color = torch.stack([0.5 + x[:, 0], 0.5 + x[:, 1],
                                 0.5 - x[:, 2]], 1).clamp(0, 1)
            res = composite_train_flat(sigma, color, m["deltas"], m["ts"],
                                       m["ray_id"], m["offsets"], m["cap"],
                                       member[0])
            out.append(res["rgb"] + (1.0 - res["opacity"][:, None]))
    return torch.cat(out).reshape(n_img, n_pix, 3)


def encode_check(table, packed, xn, hcfg, at: str, n_valid: int,
                 plain_reps: int = 50) -> dict:
    """Kernel 1 against its plain version on positions xn (within one
    bf16 ulp), with the times of both and the bound."""
    enc_k = hashgrid_encode_brick3_fwd_impl(table, xn, hcfg, packed=packed)
    enc_p = _encode_plain(packed, xn, hcfg)
    torch.cuda.synchronize()
    ulps = bf16_ulps(enc_k, enc_p)
    check(ulps <= 1.0, f"brick3_encode_fwd kernel vs plain at {at}: {ulps} "
                       "ulp")
    n, L = xn.shape[0], hcfg.n_levels
    rec = {
        "at": at, "check": "<= 1 bf16 ulp",
        "max_abs_err": float((enc_k.float() - enc_p.float()).abs().max()),
        "max_ulp": ulps,
        "exact_share": float((enc_k == enc_p).float().mean()),
        "shape": f"{n} samples ({n_valid} valid), L={L}, "
                 f"T=2^{hcfg.log2_table_size}",
        "ms": median_ms(lambda: hashgrid_encode_brick3_fwd_impl(
            table, xn, hcfg, packed=packed)),
        "plain_ms": median_ms(lambda: _encode_plain(packed, xn, hcfg),
                              reps=plain_reps, warmup=min(5, plain_reps)),
        "library_ms": None,
    }
    # x in, 2 bf16 out per (sample, level), the distinct table words read;
    # ~60 f32 operations per (sample, level) (3 fma-floor-sub, 8 weights,
    # 16 multiply-adds)
    rec.update(bound(n * 12 + n * L * 4 + brick3_words_needed(xn, hcfg) * 4,
                     n * L * 60))
    return rec


def occ_check(xyz, dt, occ_union, mcfg, at: str) -> dict:
    """Kernel 2 against its plain version on candidates (xyz, dt) (must be
    equal), with the times of both, of one indexing call, and the bound."""
    occ_k = occupancy_lookup_bricks(xyz, dt, occ_union, mcfg)
    occ_p = occupancy_lookup(xyz, dt, occ_union, mcfg)
    torch.cuda.synchronize()
    check(torch.equal(occ_k, occ_p), f"occ_lookup kernel != plain version "
                                     f"at {at}")
    flat = _occ_flat_index(xyz, dt, mcfg)
    occ_flat = occ_union.reshape(-1)
    n_cand = dt.numel()
    rec = {
        "at": at, "check": "exact",
        "max_abs_err": float((occ_k.float() - occ_p.float()).abs().max()),
        "shape": f"{tuple(dt.shape)} candidates, {tuple(occ_union.shape)} "
                 f"grid, {int(occ_k.sum())} occupied",
        "ms": median_ms(lambda: occupancy_lookup_bricks(xyz, dt, occ_union,
                                                        mcfg)),
        "plain_ms": median_ms(lambda: occupancy_lookup(xyz, dt, occ_union,
                                                       mcfg)),
        # the advanced-indexing gather of occupancy_lookup, given the
        # flat cell indices
        "library_ms": median_ms(lambda: occ_flat[flat]),
    }
    # xyz, dt in and a bool out per candidate, one byte per distinct cell;
    # ~24 f32 operations per candidate (abs/max, frexp, 3 x div-add-mul-
    # mul-clamp)
    rec.update(bound(n_cand * (12 + 4 + 1) + int(torch.unique(flat).numel()),
                     n_cand * 24))
    return rec


def table_grad_check(xn, g, hcfg, at: str, n_valid: int) -> dict:
    """Kernel 3 against its plain version (within its summation-order
    bound), with the times of both, of one index_add_ call and of the
    output's zero-fill alone, and the bound."""
    dev = xn.device
    L, T = hcfg.n_levels, hcfg.table_size
    got = hashgrid_table_grad_brick3(xn, g, hcfg)
    ref = _table_grad_plain(xn, g, hcfg)
    idx, w = _corner_terms(xn, hcfg)
    vals = (w[..., None] * g.reshape(-1, L, 2).permute(1, 0, 2)[:, None])
    flat_idx, flat_vals = idx.reshape(-1), vals.reshape(-1, 2)
    abs_sum = torch.zeros((L * T, 2), device=dev).index_add_(
        0, flat_idx, flat_vals.abs())
    count = torch.zeros(L * T, device=dev).index_add_(
        0, flat_idx, (flat_vals[:, 0] != 0).float())
    tol = 2 * (count[:, None] - 1).clamp_min(1) * 2.0**-24 * abs_sum
    err = (got - ref).abs().reshape(-1, 2)
    torch.cuda.synchronize()
    check(bool((err <= tol).all()), f"brick3_table_grad kernel vs plain at "
                                    f"{at}: max|diff| {float(err.max())}")
    rec = {
        "at": at,
        "check": "within 2 (n - 1) 2^-24 sum|terms| per entry "
                 "(atomic summation order)",
        "max_abs_err": float(err.max()),
        "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
        "shape": f"{xn.shape[0]} samples ({n_valid} valid), L={L}, "
                 f"T=2^{hcfg.log2_table_size}, out {L * T * 8 >> 20} MiB",
        "ms": median_ms(lambda: hashgrid_table_grad_brick3(xn, g, hcfg)),
        "plain_ms": median_ms(lambda: _table_grad_plain(xn, g, hcfg)),
        # one PyTorch call for the same scatter-add, given the flat corner
        # indices and products (the zero-fill included, as in the kernel)
        "library_ms": median_ms(lambda: torch.zeros(
            (L * T, 2), device=dev).index_add_(0, flat_idx, flat_vals)),
        # the wrapper's torch.zeros of the output, alone
        "zero_fill_ms": median_ms(lambda: torch.zeros((L, T, 2),
                                                      device=dev)),
    }
    # x and g read once, the 64 MiB gradient written once; ~60 f32
    # operations per valid (sample, level): 3 fma-floor-sub, 8 weights,
    # 16 products, 16 adds
    rec.update(bound(xn.shape[0] * (12 + 8 * L) + L * T * 8,
                     n_valid * L * 60))
    return rec


def print_check(name: str, rec: dict) -> None:
    extra = (f", {rec['max_err_over_tol']:.3g} of its bound, zero-fill "
             f"{rec['zero_fill_ms']:.4f} ms" if "zero_fill_ms" in rec else "")
    print(f"[kernels] {name} at {rec['at']}: {rec['check']} ok (max|diff| "
          f"{rec['max_abs_err']:.3g}{extra}) on {rec['shape']}; median "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
          f"{rec['library_ms']}, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")


def microbatch_checks(trainer, at: str) -> dict:
    """All three kernels against their plain versions at one training
    microbatch's shapes, on the trainer's current parameters, grids and
    budget: the union march's lattice candidates of a 2048-ray batch
    slice (kernel 2), its marched samples (kernels 1 and 3, with a random
    output gradient on the valid slots, zero elsewhere, as the path
    gives). Returns {kernel name: check record}."""
    dev = trainer.data["directions"].device
    hcfg = trainer.cfg.hash
    gen = torch.Generator(device=dev).manual_seed(7)
    mb = trainer.tcfg.batch_size // trainer.tcfg.n_microbatch
    batch = tt.sample_batch(gen, trainer.data, mb)
    poses = trainer.data["poses"][batch["img_idxs"]]
    rays_o, rays_d = get_rays(trainer.data["directions"][batch["pix_idxs"]],
                              poses)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    state = trainer.model_state
    center, half = scene_center_half(state)
    t1, t2 = scene_near_far(rays_o, rays_d, center, half, NEAR_DISTANCE)
    mcfg = trainer.rcfg.march(trainer.cfg)
    _, dt, xyz, _ = _lattice_candidates(rays_o, rays_d, t1, t2, mcfg,
                                        batch["noise"])
    occ_union = state["occ"].any(dim=0).contiguous()
    m, _ = march_rays_union_flat(
        rays_o, rays_d, t1, t2, state["occ"], mcfg, batch["noise"],
        budget_per_ray=trainer.rcfg.budget_per_ray,
        cap_scale=trainer.cfg.n_experts)
    rid = m["ray_id"].long()
    x = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])
    xn = ((x - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
          ).clamp(0.0, 1.0).contiguous()
    n_valid = int(m["total"])
    g = torch.randn((xn.shape[0], 2 * hcfg.n_levels), generator=gen,
                    device=dev)
    g = torch.where(m["valid"][:, None], g, 0.0).contiguous()
    table = trainer.bundle["model"]["hash_table"].detach()
    recs = {
        "occ_lookup": occ_check(xyz, dt, occ_union, mcfg, at),
        "brick3_encode_fwd": encode_check(
            table, pack_brick3_table(table), xn, hcfg, at, n_valid),
        "brick3_table_grad": table_grad_check(xn, g, hcfg, at, n_valid),
    }
    for name, rec in recs.items():
        print_check(name, rec)
    return recs


def grid_update_check(trainer) -> dict:
    """Kernel 1 against its plain version on one expert's warmup grid
    update: every cell of the grid at its jittered position."""
    cfg = trainer.cfg
    dev = trainer.data["directions"].device
    gen = torch.Generator(device=dev).manual_seed(8)
    xyz = cell_world_positions(all_cell_coords(cfg, dev), 0, cfg, gen)
    state = trainer.model_state
    xn = ((xyz - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
          ).clamp(0.0, 1.0).contiguous()
    table = trainer.bundle["model"]["hash_table"].detach()
    rec = encode_check(table, pack_brick3_table(table), xn, cfg.hash,
                       "warmup grid update", xn.shape[0], plain_reps=10)
    print_check("brick3_encode_fwd", rec)
    return rec


def train_phase(cfg: MNGPConfig, dev) -> tuple:
    """The training slice at full width. Returns ({kernel name: its check
    records at training shapes}, launch counts of the TRAIN_STEPS steps,
    summary)."""
    t0 = time.perf_counter()
    store = sphere_store(STORE_IMAGES, STORE_SIDE, dev)
    store["rays"] = render_sphere(store, cfg)
    torch.cuda.synchronize()
    n_rays = store["rays"].shape[0] * store["rays"].shape[1]
    print(f"[train] ray store: {n_rays} rays ({STORE_IMAGES} cameras x "
          f"{STORE_SIDE}x{STORE_SIDE}), targets rendered in "
          f"{time.perf_counter() - t0:.1f} s; mean colour "
          f"{float(store['rays'].mean()):.4f}")
    tcfg = tt.TrainConfig()
    gen = torch.Generator().manual_seed(1)
    trainer = tt.Trainer(cfg, tcfg, init_mngp(gen, cfg, device=dev),
                         init_ray_gate(gen, cfg.n_experts, device=dev),
                         init_mngp_state(cfg, device=dev), store,
                         torch.Generator(device=dev).manual_seed(2))
    check(tcfg.n_microbatch == 4, "batch 8192 must take 4 microbatches")
    trainer.update_grid(warmup=True)        # the state a first step sees
    checks = {name: [rec] for name, rec in microbatch_checks(
        trainer, f"train step 0 (budget {trainer.rcfg.budget_per_ray})"
    ).items()}
    checks["brick3_encode_fwd"].append(grid_update_check(trainer))
    trainer.model_state = init_mngp_state(cfg, device=dev)

    log, secs = [], []
    t_last = [0.0]

    def on_step(step, loss, aux):
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs.append(now - t_last[0])
        t_last[0] = now
        if step % 32 == 0 or step == TRAIN_STEPS - 1:
            rec = {"step": step, "loss": float(loss),
                   "psnr": float(aux["psnr"]),
                   "budget_per_ray": trainer.rcfg.budget_per_ray,
                   "budget_util": float(aux["budget_util"]),
                   "occ": float(trainer.model_state["occ"].float().mean())}
            log.append(rec)
            print(f"[train] step {step}: loss {rec['loss']:.5f} psnr "
                  f"{rec['psnr']:.2f} budget {rec['budget_per_ray']} util "
                  f"{rec['budget_util']:.3f} occupied {rec['occ']:.4f}")
        else:
            log.append({"step": step, "loss": float(loss),
                        "psnr": float(aux["psnr"])})

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_last[0] = t0 = time.perf_counter()
    trainer.fit_steps(TRAIN_STEPS, on_step)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    rates = [tcfg.batch_size / s for s in secs[16:]]
    losses = [r["loss"] for r in log]
    psnrs = [r["psnr"] for r in log]
    first, last = float(np.mean(psnrs[:16])), float(np.mean(psnrs[-16:]))
    print(f"[train] {TRAIN_STEPS} steps of {tcfg.batch_size} rays in "
          f"{total:.1f} s; train rays/s median {np.median(rates):.0f} over "
          f"steps 16-{TRAIN_STEPS - 1} (min {min(rates):.0f}, max "
          f"{max(rates):.0f}); psnr {first:.2f} -> {last:.2f} dB (mean of "
          f"the first and last 16 steps); budget {trainer.rcfg.budget_per_ray}"
          f"; launches {launches}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(last > first + 3.0, f"psnr did not rise: {first} -> {last}")
    n_updates = -(-TRAIN_STEPS // tt.UPDATE_INTERVAL)
    mb = tcfg.n_microbatch
    check(launches["brick3_table_grad"] == mb * TRAIN_STEPS,
          f"kernel 3 launched {launches['brick3_table_grad']} times, not "
          f"{mb} x {TRAIN_STEPS}")
    check(launches["occ_lookup"] == mb * TRAIN_STEPS, "occ_lookup launches")
    check(launches["brick3_encode_fwd"]
          == mb * TRAIN_STEPS + n_updates * cfg.n_experts * cfg.cascades,
          "brick3_encode_fwd launches")

    for name, rec in microbatch_checks(
            trainer, f"train step {TRAIN_STEPS} (budget "
                     f"{trainer.rcfg.budget_per_ray})").items():
        checks[name].append(rec)
    prof = profile_call(
        lambda: trainer.train_step(tt.sample_batch(
            trainer.gen, trainer.data, tcfg.batch_size)),
        f"one training step ({tcfg.batch_size} rays, {mb} microbatches)")
    train_vs_cpu(trainer)
    summary = {"rays_per_s": float(np.median(rates)), "psnr_first": first,
               "psnr_last": last, "loss_last": losses[-1],
               "budget_per_ray": trainer.rcfg.budget_per_ray,
               "seconds": total, "profile": prof}
    return checks, launches, summary


def train_vs_cpu(trainer) -> None:
    """One 256-ray step at full width on the card and on the CPU (plain
    versions) from the trainer's parameters and state and the same draws:
    loss, sample counts and every gradient leaf."""
    dev = trainer.data["directions"].device
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = tt.sample_batch(gen, trainer.data, CPU_RAYS)
    results = []
    for where in (dev, torch.device("cpu")):
        move = lambda t: t.detach().to(where)
        bundle = tree_unflatten(trainer.bundle,
                                [move(p) for p in tree_leaves(trainer.bundle)])
        for p in tree_leaves(bundle):
            p.requires_grad_(True)
        state = {k: move(v) for k, v in trainer.model_state.items()}
        data = {k: move(v) for k, v in trainer.data.items()}
        b = {k: move(v) for k, v in batch.items()}
        vg = microbatched_value_and_grad(lambda p, bt: tt.loss_fn(
            p, state, bt, data, trainer.cfg, trainer.rcfg, trainer.tcfg), 1)
        (loss, aux), grads = vg(bundle, b)
        results.append((float(loss), {k: float(v) for k, v in aux.items()},
                        [g.cpu() for g in tree_leaves(grads)]))
    (lg, ag, gg), (lc, ac, gc) = results
    worst = max(float((a - c).abs().max() / c.abs().max().clamp_min(1e-30))
                for a, c in zip(gg, gc))
    print(f"[train] card vs CPU plain, one {CPU_RAYS}-ray step: loss "
          f"{lg:.6f} vs {lc:.6f}, samples {ag['rm_samples']:.0f} vs "
          f"{ac['rm_samples']:.0f}, worst gradient leaf max|diff| / max|ref| "
          f"{worst:.3g} over {len(gg)} leaves (tolerance loss "
          f"{TRAIN_CPU_LOSS_RTOL} relative, leaves {TRAIN_CPU_GRAD_RTOL})")
    check(ag["rm_samples"] == ac["rm_samples"],
          "card and CPU marched different samples")
    check(abs(lg - lc) <= TRAIN_CPU_LOSS_RTOL * abs(lc), "card vs CPU loss")
    check(worst <= TRAIN_CPU_GRAD_RTOL, "card vs CPU gradient leaves")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false); nothing was run")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    built = kernels.build(ptxas_info=True)
    print(f"[build] {len(built)} kernels in "
          f"{time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name, (sec, log) in built.items():
        print(f"[build] {name}: {sec:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    cfg = MNGPConfig(scale=0.5, log2_T=19, grid_size=128, n_experts=2,
                     compute_dtype="bfloat16", hash_impl="brick3")
    rcfg = RenderConfig()
    mcfg = rcfg.march(cfg)
    hcfg = cfg.hash
    gen = torch.Generator().manual_seed(0)
    params = init_mngp(gen, cfg, device=dev)
    gate = init_ray_gate(gen, cfg.n_experts, device=dev)
    state = {**init_mngp_state(cfg, device=dev),
             "occ": occupancy(cfg, dev)}
    directions, pose = camera(SIDE, dev)
    n_pix = directions.shape[0]

    # 3. kernels vs plain, on the first iteration of the middle chunk
    c0 = (n_pix // CHUNK // 2) * CHUNK
    rays_o, rays_d = get_rays(directions[c0:c0 + CHUNK], pose)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    center, half = scene_center_half(state)
    t1, t2 = scene_near_far(rays_o, rays_d, center, half, NEAR_DISTANCE)
    occ_union = state["occ"].any(dim=0).contiguous()
    k = torch.arange(rcfg.test_k_block, device=dev, dtype=torch.int32)
    t = sample_lattice(t1[:, None], k[None, :], mcfg)
    dt = calc_dt(t, mcfg)
    xyz = fma32(t[..., None], rays_d[:, None, :], rays_o[:, None, :])

    at = "render iteration 0"
    render_checks = {"occ_lookup": occ_check(xyz, dt, occ_union, mcfg, at)}

    m = march_rays_test_flat(
        rays_o, rays_d, t1, t2, occ_union, mcfg, t1 >= 0,
        k_block=rcfg.test_k_block, cap_per_ray=rcfg.test_block_samples,
        budget_per_ray=rcfg.test_budget_per_ray,
    )
    rid = m["ray_id"].long()
    xs = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])
    xn = ((xs - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
          ).clamp(0.0, 1.0).contiguous()
    table = params["hash_table"]
    render_checks["brick3_encode_fwd"] = encode_check(
        table, pack_brick3_table(table), xn, hcfg, at, int(m["total"]))
    for name, rec in render_checks.items():
        print_check(name, rec)

    # 4. the slice at full width (one chunk first: allocator/cuBLAS warm-up)
    render_rays_chunked(params, state, cfg, gate, directions[:CHUNK], pose,
                        rcfg, chunk=CHUNK)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = render_rays_chunked(params, state, cfg, gate, directions, pose,
                              rcfg, chunk=CHUNK)
    torch.cuda.synchronize()
    secs = [time.perf_counter() - t0]
    launches = dict(kernels.launch_counts)
    for _ in range(RENDER_REPEATS - 1):      # the spread of the same render
        t0 = time.perf_counter()
        render_rays_chunked(params, state, cfg, gate, directions, pose, rcfg,
                            chunk=CHUNK)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    rates = [n_pix / s for s in secs]
    print(f"[render] {SIDE}x{SIDE} = {n_pix} rays: median "
          f"{float(np.median(rates)):.0f} rays/s over {len(rates)} renders "
          f"({', '.join(f'{r:.0f}' for r in rates)}); {out['iterations']} "
          f"loop iterations over {-(-n_pix // CHUNK)} chunks; "
          f"{out['total_samples']} samples; launches {launches} (first "
          f"render)")
    for name in ("occ_lookup", "brick3_encode_fwd"):
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "render")
    for key in ("rgb", "depth", "opacity"):
        check(bool(torch.isfinite(out[key]).all()), f"non-finite {key}")
    check(out["rgb"].shape == (n_pix, 3) and out["depth"].shape == (n_pix,),
          "output shapes")
    op = out["opacity"]
    check(bool(((op >= 0) & (op <= 1)).all()), "opacity outside [0, 1]")
    covered = float((op > 0.01).float().mean())
    check(covered > 0, "empty image")
    print(f"[render] covered share {covered:.4f}, mean opacity "
          f"{float(op.mean()):.4f}, rgb range [{float(out['rgb'].min()):.4f},"
          f" {float(out['rgb'].max()):.4f}]")
    profile_call(lambda: render_rays_chunked(
        params, state, cfg, gate, directions[c0:c0 + CHUNK], pose, rcfg,
        chunk=CHUNK))

    # the centre row's middle 256 pixels, on the card and on the CPU
    p0 = (SIDE // 2) * SIDE + (SIDE - CPU_RAYS) // 2
    dirs = directions[p0:p0 + CPU_RAYS]
    gpu = render_rays_chunked(params, state, cfg, gate, dirs, pose, rcfg,
                              chunk=CPU_RAYS)
    cpu = render_rays_chunked(to_cpu(params), to_cpu(state), cfg,
                              to_cpu(gate), dirs.cpu(), pose.cpu(), rcfg,
                              chunk=CPU_RAYS)
    diffs = {k: float((gpu[k].cpu() - cpu[k]).abs().max()) for k in CPU_TOL}
    print(f"[render] card vs CPU plain on {CPU_RAYS} rays: max|diff| "
          f"{diffs} (tolerance {CPU_TOL}); samples {gpu['total_samples']} "
          f"vs {cpu['total_samples']}")
    for k, tol in CPU_TOL.items():
        check(diffs[k] <= tol, f"card vs CPU {k}: {diffs[k]} > {tol}")
    check(gpu["total_samples"] == cpu["total_samples"],
          "card and CPU marched different samples")

    # 5. the training slice at full width
    train_checks, train_launches, summary = train_phase(cfg, dev)
    print(json.dumps({"train": summary}))

    # 6. kernels line: launches of the training run (this slice's main
    # path, which runs all three) and of the render; ms, plain, library
    # and bound at a training step 0 microbatch, the shape of most
    # launches; max_abs_err the worst of every check, all in "checks"
    sources = {
        "occ_lookup": ("radnerf_tpu_torch/csrc/occ_lookup.cu",
                       "radnerf_tpu/ops/marching.py:312"),
        "brick3_encode_fwd": ("radnerf_tpu_torch/csrc/brick3_encode_fwd.cu",
                              "radnerf_tpu/ops/hashgrid_brick3.py:257"),
        "brick3_table_grad": ("radnerf_tpu_torch/csrc/brick3_table_grad.cu",
                              "radnerf_tpu/ops/hashgrid_brick3.py:493"),
    }
    recs = []
    for name, (source, replaces) in sources.items():
        check(train_launches[name] > 0, f"kernel {name} not launched")
        runs = train_checks[name] + (
            [render_checks[name]] if name in render_checks else [])
        main_rec = runs[0]
        recs.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[name],
            "launches_by_path": {"train": train_launches[name],
                                 "render": launches[name]},
            "max_abs_err": max(r["max_abs_err"] for r in runs),
            **{k: main_rec[k] for k in ("shape", "ms", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "bound_by")},
            "checks": runs, "ok": True,
        })
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
