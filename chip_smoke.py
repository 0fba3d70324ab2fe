#!/usr/bin/env python3
"""Drive the PyTorch port's Rad-NeRF MoE render and training, and its
examples' microbenchmark kernels, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure is an uncaught error and a nonzero exit; there is no
CPU fallback):
  1. device: the card's name and power limit, from nvidia-smi;
  2. build: compile every CUDA kernel of the path from csrc/ (nvcc, sm_90a);
  3. kernels 1 and 2 vs their plain PyTorch versions on the card, at the
     shapes of the render's first loop iteration on a 4096-ray chunk: the
     candidate occupancy on 4096 x 512 candidates (must be equal), the
     brick3 encode on the iteration's 98,304 marched samples at L=16,
     T=2^19 (within one bf16 ulp, reading the packed table and reading the
     f32 table); median times of kernel, plain version and library call,
     and the device time of the training step's call (the f32 table);
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
     own march and compositor render (no dataset); then every kernel
     against its plain version at one 2048-ray microbatch's shapes (the
     union march's 2048 x 1024 lattice candidates, its marched samples,
     the table gradient of a random output gradient; the tcnn, slab and
     brick scatter kernels on the streams their families' backwards build
     from the same samples and gradient), with each kernel's and library
     call's device time alone (a CUDA graph of 20 calls), the PyTorch
     forwards of the other families timed on the same samples, the
     brick3, tcnn, slab and brick table gradients on six streams made for
     their warp aggregation, and the encode on one warmup grid update's
     2,097,152 cells; then TRAIN_STEPS steps of
     Trainer.fit_steps (grid updates every 16 steps, every cell below
     step 256, the adaptive budget), launch counts reset just before and
     read just after; loss and PSNR at intervals, train rays/s (median
     over the steps after the first 16); the microbatch checks again at
     the trained grids and the grown budget; one step profiled; the
     encode alone timed (forward and backward) at a trained microbatch;
     then one 256-ray step on the card and on the CPU (plain versions)
     from the same parameters and draws, loss and every gradient leaf
     compared (each leaf printed with its worst entry);
  6. the 'dedup' family (the tcnn hash, whose backward is the
     tcnn_table_grad kernel) trained the same way from the same seeds for
     DEDUP_STEPS steps: PSNR must rise, the launch counts are exact
     (tcnn_table_grad once per microbatch, no brick3 kernel); one step
     profiled; the encode alone timed; 256-ray card-vs-CPU steps on seed 3
     and PIN_SEEDS, each leaf held against the CPU step that takes the
     card's forward once the two forwards are found equal up to their
     bf16 roundings (TRAIN_CPU_GRAD_RTOL); and one float32 step
     (compute_dtype float32, hash_impl brick3, which routes to 'dedup')
     card against CPU;
  7. short runs of the 'slab', 'brick' and 'pallas' families
     (FAMILY_STEPS steps each): finite losses, exact launch counts of
     their kernels, the encode alone timed, and a 256-ray card-vs-CPU
     step each;
  8. the examples' kernels: bench_vmem_gather and proto_pallas_gather
     run at their default sizes (4,194,304 words from a (4096, 128) table;
     2^20 rows gathered from and added into a (2^19, 2) table), and
     bench_vmem_gather again on a (WIDE_ROWS, 128) table, too large for
     tal_sublane to stage, so that its wrapper launches tal_sublane_l2;
     launch counts reset just before and read just after; then each of
     their five kernels against its plain twin at those sizes (the four
     gathers bit-equal, also on their script's edge draw, `with_edges`;
     the scatter within its f32 order bound), median
     times of kernel, twin and library call, and the device time of
     kernel and library call without host gaps (CUDA graphs); then
     profile_step at its defaults (the dedup step split into its
     parts);
  9. a JSON line with every kernel's check, launches (per phase), times
     and bound;
 10. the last line: {"ok": true, "device": {...}}.

Phase 4 also renders 256 rays with hash_impl 'dedup' on the card and on
the CPU (no brick3 table is packed for it, and no brick3 kernel runs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

import radnerf_tpu_torch.render.ml_render as ml_render_mod
from radnerf_tpu_torch import kernels
from radnerf_tpu_torch.examples import bench_vmem_gather as tvg
from radnerf_tpu_torch.examples import profile_step
from radnerf_tpu_torch.examples import proto_pallas_gather as tpg
from radnerf_tpu_torch.models.gates import init_ray_gate
from radnerf_tpu_torch.models.mlp import layer_tap
from radnerf_tpu_torch.models.mngp import MNGPConfig, init_mngp, init_mngp_state
from radnerf_tpu_torch.models.ngp import (
    all_cell_coords, cell_world_positions, scene_center_half,
)
from radnerf_tpu_torch.ops import hashgrid_brick, hashgrid_slab
from radnerf_tpu_torch.ops.compositing import composite_train_flat
from radnerf_tpu_torch.ops.fma import fma32
from radnerf_tpu_torch.ops.hashgrid import (
    encode_dispatch, hashgrid_encode, hashgrid_indices, hashgrid_indices_cm,
)
from radnerf_tpu_torch.ops.hashgrid_brick3 import (
    _corner_terms, _encode_plain, _table_grad_plain,
    hashgrid_encode_brick3_fwd_impl, hashgrid_table_grad_brick3,
    pack_brick3_table,
)
from radnerf_tpu_torch.ops.hashgrid_dedup import (
    hashgrid_encode_dedup_fwd_impl,
)
from radnerf_tpu_torch.ops.hashgrid_pallas import (
    hashgrid_table_grad, point_stream,
)
from radnerf_tpu_torch.ops.hashgrid_window import (
    hashgrid_table_grad_window, tcnn_stream,
)
from radnerf_tpu_torch.ops.intersection import scene_near_far
from radnerf_tpu_torch.ops.marching import (
    _lattice_candidates, _occ_flat_index, calc_dt, march_rays_test_flat,
    march_rays_union_flat, occupancy_lookup, occupancy_lookup_bricks,
    sample_lattice,
)
from radnerf_tpu_torch.ops.stream_table_grad import (
    stream_table_grad, stream_table_grad_plain, stream_terms,
)
from radnerf_tpu_torch.parallel.step import (
    microbatched_value_and_grad, tree_leaves, tree_paths, tree_unflatten,
)
from radnerf_tpu_torch.render.ml_render import get_rays, render_rays_chunked
from radnerf_tpu_torch.render.render import NEAR_DISTANCE, RenderConfig
from radnerf_tpu_torch.train import trainer as tt

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32, outside the tensor cores
T_START = time.perf_counter()
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
# card vs CPU, one 256-ray training step: the rays, the march and the
# encode are exact on both (phase 3; render/ml_render.py::get_rays), the
# table gradient is the same f32 sum in another (atomic) order; the bf16
# MLPs (cuBLAS vs the CPU) may round an output one bf16 ulp apart (2^-8
# relative), which the backward carries into every leaf: the loss within
# 1%, each gradient leaf within 2% of its largest entry.
# The dedup check (pin_forward): a bf16 layer output h = bf16(bf16(mm) + b)
# of the two sides, from the same inputs, is two roundings of sums of the
# same K products in two orders, each within K 2^-23 sum|terms| of the
# exact sum (a truncating tensor-core adder included): |h_card - h_cpu|
# <= ulp(mm) + ulp(h) + 2 K 2^-23 (|x| @ |w|). The MLPs' inputs are the
# rays, the encode (both exact) and the SH encode of the unit ray
# directions, whose norm sums three squares in two orders (the CPU's
# vector_norm fuses them): each unit component within 6 f32 ulps, and a
# basis polynomial (degree <= 3, coefficients <= 2.9) within ~81 2^-24,
# under 2^-16, before its cast to bf16: |x_card - x_cpu| <= ulp(x) +
# 2^-16. One such step in a density
# logit moves sigma = exp(h) by up to 6% (ulp(h) = 2^-4 on [8, 16)), and
# the compositor carries that to the ray's later samples and every leaf,
# beyond any bound on the leaves; so, once every layer output is found
# within that bound (and the encode features equal), the card's step is
# held against the CPU step that takes the card's forward values. What
# is left is the backward's: each bf16 gradient one rounding apart, one
# bf16 ulp of a leaf entry being at most 2^-7 of the leaf's largest, so
# 2% holds 2.5 of them. Except where the leaf cancels: the ray gate's
# output layer (gate/encoder/b/4 read 0.0533 of its largest entry on an
# H100). Its softmax makes each logit's gradient a difference, p_k (g_k -
# p.g), which training drives towards zero as the experts agree, and
# which each side casts to bf16 from f32 values far closer than a bf16
# ulp: each term one rounding apart at most, 2^-7 of itself. The layer's
# leaves sum these terms over the rays (the weight: times the layer's
# input, the same on both sides) in f32, in two orders (2 K 2^-24 of
# the sum of magnitudes, K = CPU_RAYS), and round the entry once more to
# bf16 (2^-7 of it): |diff| <= (2^-6 + 2 K 2^-24) sum|terms| < 0.016
# sum|terms|, while the entries themselves cancel to 1.1-772x below it
# (H100 runs). So the output layer's two leaves are held at 2% of their
# largest sum of term magnitudes, |x|^T |dL/dlogits| (bias: sum
# |dL/dlogits|); the inner gate layers, never seen beyond 0.0071 of
# their largest entry on an H100, are held at it like every other leaf,
# which also catches a halved gate gradient (checked on every batch).
TRAIN_CPU_LOSS_RTOL = 1e-2
TRAIN_CPU_GRAD_RTOL = 2e-2
# the same in float32: the MLPs' f32 sums in other orders (cuBLAS vs the
# CPU); the first geo layer's weight gradient sums tiny hash features
# with much cancellation, so its leaf moves most
TRAIN_CPU_F32_LOSS_RTOL = 1e-4
TRAIN_CPU_F32_GRAD_RTOL = 5e-3
DEDUP_STEPS = 320               # the dedup family: as long as phase 5
# samples of each aggregation stream: a step-0 microbatch's slots
AGG_SAMPLES = 2048 * 64
# the dedup card-vs-CPU check: further 256-ray batches of the trained
# state, held beside seed 3 (TRAIN_CPU_GRAD_RTOL)
PIN_SEEDS = tuple(range(10, 58))
FAMILY_STEPS = 48               # slab, brick, pallas: 3 warmup updates
WIDE_ROWS = 8192                # phase 8: a table above the staged limit
# hash family -> its table-gradient kernel
FAMILY_KERNELS = {"brick3": "brick3_table_grad",
                  "dedup": "tcnn_table_grad", "slab": "slab_table_grad",
                  "brick": "brick_table_grad", "pallas": "tcnn_table_grad"}


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


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at |x|, elementwise, in float32."""
    x = x.float().abs()
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in units of the bf16 ulp of max(|a|, |b|)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(mag > 0, bf16_ulp(mag), 1.0)
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


def render_scene(dev) -> dict:
    """Phase 4's model: MNGP zoo=2 at full width (scale 0.5, T=2^19,
    G=128, bf16, brick3) from torch.Generator seed 0, expert 0 occupying a
    solid 0.3-radius sphere and expert 1 its +x half, and the 400x400
    camera."""
    cfg = MNGPConfig(scale=0.5, log2_T=19, grid_size=128, n_experts=2,
                     compute_dtype="bfloat16", hash_impl="brick3")
    gen = torch.Generator().manual_seed(0)
    params = init_mngp(gen, cfg, device=dev)
    gate = init_ray_gate(gen, cfg.n_experts, device=dev)
    state = {**init_mngp_state(cfg, device=dev),
             "occ": occupancy(cfg, dev)}
    directions, pose = camera(SIDE, dev)
    return {"cfg": cfg, "rcfg": RenderConfig(), "params": params,
            "gate": gate, "state": state, "directions": directions,
            "pose": pose}


def render_iteration(scene: dict) -> dict:
    """The first loop iteration of the render's middle chunk (from ray
    c0): its lattice candidates (xyz, dt) against the union grid, and its
    marched samples xn in [0, 1]^3, n_valid of them valid."""
    cfg, rcfg, state = scene["cfg"], scene["rcfg"], scene["state"]
    mcfg = rcfg.march(cfg)
    dev = scene["directions"].device
    c0 = (scene["directions"].shape[0] // CHUNK // 2) * CHUNK
    rays_o, rays_d = get_rays(scene["directions"][c0:c0 + CHUNK],
                              scene["pose"])
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    center, half = scene_center_half(state)
    t1, t2 = scene_near_far(rays_o, rays_d, center, half, NEAR_DISTANCE)
    occ_union = state["occ"].any(dim=0).contiguous()
    k = torch.arange(rcfg.test_k_block, device=dev, dtype=torch.int32)
    t = sample_lattice(t1[:, None], k[None, :], mcfg)
    dt = calc_dt(t, mcfg)
    xyz = fma32(t[..., None], rays_d[:, None, :], rays_o[:, None, :])
    m = march_rays_test_flat(
        rays_o, rays_d, t1, t2, occ_union, mcfg, t1 >= 0,
        k_block=rcfg.test_k_block, cap_per_ray=rcfg.test_block_samples,
        budget_per_ray=rcfg.test_budget_per_ray,
    )
    rid = m["ray_id"].long()
    xs = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])
    xn = ((xs - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
          ).clamp(0.0, 1.0).contiguous()
    return {"c0": c0, "xyz": xyz, "dt": dt, "occ_union": occ_union,
            "mcfg": mcfg, "xn": xn, "n_valid": int(m["total"])}


def encode_check(table, packed, xn, hcfg, at: str, n_valid: int,
                 plain_reps: int = 50) -> dict:
    """Kernel 1 against its plain version on positions xn (within one
    bf16 ulp), reading the packed words and reading the f32 table, with
    the times of both, the plain version's and the bounds. `ms`,
    `device_ms` and `bound_ms` are those of the packed read (`form`: the
    render's and the grid update's call, which pack once beforehand,
    `pack_device_ms`); `train_path_device_ms` and `train_path_bound_ms`
    those of the call as the training step makes it, on the f32 table
    with no pack."""
    enc_a = hashgrid_encode_brick3_fwd_impl(table, xn, hcfg, packed=packed)
    enc_b = hashgrid_encode_brick3_fwd_impl(table, xn, hcfg)
    enc_p = _encode_plain(packed, xn, hcfg)
    torch.cuda.synchronize()
    check(torch.equal(_encode_plain(table, xn, hcfg), enc_p),
          f"brick3 plain encode of the f32 table != of the packed words at "
          f"{at}")
    ulps = {form: bf16_ulps(enc, enc_p)
            for form, enc in (("packed", enc_a), ("f32", enc_b))}
    for form, u in ulps.items():
        check(u <= 1.0, f"brick3_encode_fwd kernel ({form} table) vs plain "
                        f"at {at}: {u} ulp")
    n, L = xn.shape[0], hcfg.n_levels
    rec = {
        "at": at, "check": "<= 1 bf16 ulp (packed and f32 table)",
        "form": "packed bf16x2 words (render, grid update)",
        "max_abs_err": max(float((enc.float() - enc_p.float()).abs().max())
                           for enc in (enc_a, enc_b)),
        "max_ulp": max(ulps.values()),
        "exact_share": float((enc_a == enc_p).float().mean()),
        "exact_share_f32": float((enc_b == enc_p).float().mean()),
        "shape": f"{n} samples ({n_valid} valid), L={L}, "
                 f"T=2^{hcfg.log2_table_size}",
        "ms": median_ms(lambda: hashgrid_encode_brick3_fwd_impl(
            table, xn, hcfg, packed=packed)),
        "device_ms": graph_ms(lambda: hashgrid_encode_brick3_fwd_impl(
            table, xn, hcfg, packed=packed)),
        "train_path_device_ms": graph_ms(
            lambda: hashgrid_encode_brick3_fwd_impl(table, xn, hcfg)),
        "pack_device_ms": graph_ms(lambda: pack_brick3_table(table)),
        "plain_ms": median_ms(lambda: _encode_plain(packed, xn, hcfg),
                              reps=plain_reps, warmup=min(5, plain_reps)),
        "library_ms": None, "library_device_ms": None,
        "library_call": "none: no PyTorch call computes a hash-grid encode",
    }
    # x in, 2 bf16 out per (sample, level), the distinct table entries
    # read: 4-byte words packed, 8-byte f32 pairs on the training path;
    # ~60 f32 operations per (sample, level) (3 fma-floor-sub, 8 weights,
    # 16 multiply-adds)
    io, ops = n * 12 + n * L * 4, n * L * 60
    entries = brick3_words_needed(xn, hcfg)
    rec.update(bound(io + entries * 4, ops))
    rec["train_path_bound_ms"] = bound(io + entries * 8, ops)["bound_ms"]
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
        "device_ms": graph_ms(lambda: occupancy_lookup_bricks(
            xyz, dt, occ_union, mcfg)),
        "plain_ms": median_ms(lambda: occupancy_lookup(xyz, dt, occ_union,
                                                       mcfg)),
        # the advanced-indexing gather of occupancy_lookup, given the flat
        # cell indices: not a yardstick for the same function (no PyTorch
        # call computes the lookup from positions)
        "library_ms": median_ms(lambda: occ_flat[flat]),
        "library_device_ms": graph_ms(lambda: occ_flat[flat]),
        "library_call": "a gather of precomputed cell indices (less work)",
    }
    # xyz, dt in and a bool out per candidate, one byte per distinct cell;
    # ~24 f32 operations per candidate (abs/max, frexp, 3 x div-add-mul-
    # mul-clamp)
    rec.update(bound(n_cand * (12 + 4 + 1) + int(torch.unique(flat).numel()),
                     n_cand * 24))
    return rec


def brick3_grad_err(xn, g, hcfg, got) -> tuple:
    """|got - the plain twin| of kernel 3 on (xn, g) and its summation-order
    bound: the same f32 products summed by atomics in an order that
    changes from run to run, within 2 (n - 1) u sum|terms| per table entry
    (n terms, u = 2^-24). Returns (err, tol), each (L * T, 2)."""
    dev = xn.device
    L, T = hcfg.n_levels, hcfg.table_size
    ref = _table_grad_plain(xn, g, hcfg)
    idx, w = _corner_terms(xn, hcfg)
    vals = (w[..., None] * g.reshape(-1, L, 2).permute(1, 0, 2)[:, None])
    flat_idx, flat_vals = idx.reshape(-1), vals.reshape(-1, 2)
    abs_sum = torch.zeros((L * T, 2), device=dev).index_add_(
        0, flat_idx, flat_vals.abs())
    count = torch.zeros(L * T, device=dev).index_add_(
        0, flat_idx, (flat_vals[:, 0] != 0).float())
    tol = 2 * (count[:, None] - 1).clamp_min(1) * 2.0**-24 * abs_sum
    return (got - ref).abs().reshape(-1, 2), tol


def stream_grad_err(name, keys, vals, T: int, got) -> tuple:
    """|got - the plain twin| of a stream kernel and its summation-order
    bound, 2 (n - 1) u sum|terms| per table entry. Returns (err, tol, the
    stream's terms)."""
    dev = keys.device
    L = keys.shape[0]
    ref = stream_table_grad_plain(name, keys, vals, T)
    flat, terms = stream_terms(name, keys, vals, T)
    abs_sum = torch.zeros((L * T, 2), device=dev).index_add_(
        0, flat, terms.abs())
    count = torch.zeros((L * T, 2), device=dev).index_add_(
        0, flat, (terms != 0).float())
    tol = 2 * (count - 1).clamp_min(1) * 2.0**-24 * abs_sum
    return (got - ref).abs().reshape(-1, 2), tol, terms


ORDER_CHECK = ("within 2 (n - 1) 2^-24 sum|terms| per entry (atomic "
               "summation order)")


def table_grad_check(xn, g, hcfg, at: str, n_valid: int) -> dict:
    """Kernel 3 against its plain version (within its summation-order
    bound), with the times of both, of one index_add_ call and of the
    output's zero-fill alone, the wrapper's and the index_add_'s device
    time alone, and the bound."""
    dev = xn.device
    L, T = hcfg.n_levels, hcfg.table_size
    err, tol = brick3_grad_err(xn, g, hcfg,
                               hashgrid_table_grad_brick3(xn, g, hcfg))
    torch.cuda.synchronize()
    check(bool((err <= tol).all()), f"brick3_table_grad kernel vs plain at "
                                    f"{at}: max|diff| {float(err.max())}")
    idx, w = _corner_terms(xn, hcfg)
    vals = (w[..., None] * g.reshape(-1, L, 2).permute(1, 0, 2)[:, None])
    flat_idx, flat_vals = idx.reshape(-1), vals.reshape(-1, 2)

    def library():
        return torch.zeros((L * T, 2), device=dev).index_add_(
            0, flat_idx, flat_vals)

    rec = {
        "at": at, "check": ORDER_CHECK,
        "max_abs_err": float(err.max()),
        "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
        "shape": f"{xn.shape[0]} samples ({n_valid} valid), L={L}, "
                 f"T=2^{hcfg.log2_table_size}, out {L * T * 8 >> 20} MiB",
        "ms": median_ms(lambda: hashgrid_table_grad_brick3(xn, g, hcfg)),
        "device_ms": graph_ms(lambda: hashgrid_table_grad_brick3(xn, g,
                                                                 hcfg)),
        "plain_ms": median_ms(lambda: _table_grad_plain(xn, g, hcfg)),
        # one PyTorch call for the same scatter-add, given the flat corner
        # indices and products (the zero-fill included, as in the kernel)
        "library_ms": median_ms(library),
        "library_device_ms": graph_ms(library),
        "library_call": "index_add_ of precomputed corner indices and "
                        "products, zero-fill included (less work)",
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


def stream_check(name: str, contract: str, keys, vals, T: int, at: str,
                 contract_fn) -> dict:
    """A scatter kernel of csrc/stream_table_grad.cu against its plain
    twin on the stream its family's backward builds (within the atomic
    summation-order bound), with the times of the kernel's wrapper, the
    twin, one index_add_ of the same terms and the whole contract
    function (the stream built from positions and gradient included), the
    wrapper's and the index_add_'s device time alone, and the bound."""
    dev = keys.device
    L, n = keys.shape
    err, tol, terms = stream_grad_err(name, keys, vals, T,
                                      stream_table_grad(name, keys, vals, T))
    torch.cuda.synchronize()
    check(bool((err <= tol).all()), f"{name} kernel vs plain ({contract}) "
                                    f"at {at}: max|diff| {float(err.max())}")
    flat, _ = stream_terms(name, keys, vals, T)
    n_terms = int((terms != 0).sum())

    def library():
        return torch.zeros((L * T, 2), device=dev).index_add_(0, flat, terms)

    rec = {
        "at": at, "contract": contract, "check": ORDER_CHECK,
        "max_abs_err": float(err.max()),
        "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
        "shape": f"{L} x {n} stream entries, {n_terms} nonzero f32 terms, "
                 f"T=2^{T.bit_length() - 1}, out {L * T * 8 >> 20} MiB",
        "ms": median_ms(lambda: stream_table_grad(name, keys, vals, T)),
        "device_ms": graph_ms(lambda: stream_table_grad(name, keys, vals,
                                                        T)),
        "plain_ms": median_ms(lambda: stream_table_grad_plain(
            name, keys, vals, T), reps=10),
        # one PyTorch call for the same scatter-add, given the flat
        # entries and terms (the zero-fill included, as in the kernel)
        "library_ms": median_ms(library),
        "library_device_ms": graph_ms(library),
        "library_call": "index_add_ of the precomputed flat entries and "
                        "terms, zero-fill included (less work)",
        "contract_ms": median_ms(contract_fn, reps=10),
    }
    # keys and value planes read once, the 64 MiB gradient written once;
    # one f32 add per nonzero term
    rec.update(bound(keys.numel() * 4 + vals.numel() * 4 + L * T * 8,
                     n_terms))
    return rec


def stream_checks(xn, g, hcfg, at: str) -> dict:
    """Kernels 4-7 (three CUDA entry points) at one microbatch: the tcnn
    stream of the corner-major and the point-major corners, the slab pair
    stream and the brick stream of positions xn and output gradient g.
    Returns {contract: check record}."""
    T = hcfg.table_size
    recs = {}
    idx, w = hashgrid_indices_cm(xn, hcfg)
    recs["hashgrid_table_grad_window"] = stream_check(
        "tcnn_table_grad", "hashgrid_table_grad_window",
        *tcnn_stream(idx, w, g), T, at,
        lambda: hashgrid_table_grad_window(idx, w, g, hcfg))
    idx, w = hashgrid_indices(xn, hcfg)
    recs["hashgrid_table_grad"] = stream_check(
        "tcnn_table_grad", "hashgrid_table_grad", *point_stream(idx, w, g),
        T, at, lambda: hashgrid_table_grad(idx, w, g, hcfg))
    del idx, w
    recs["sorted_table_grad_window_pair"] = stream_check(
        "slab_table_grad", "sorted_table_grad_window_pair",
        *slab_stream(xn, g, hcfg), T, at,
        lambda: hashgrid_slab.hashgrid_table_grad_slab(xn, g, hcfg))
    recs["sorted_table_grad_brick"] = stream_check(
        "brick_table_grad", "sorted_table_grad_brick",
        *brick_stream(xn, g, hcfg), T, at,
        lambda: hashgrid_brick.hashgrid_table_grad_brick(xn, g, hcfg))
    return recs


def slab_stream(xn, g, hcfg) -> tuple:
    """The slab backward's pair stream of xn and g as slab_table_grad
    takes it: keys (L, n) and the planes (f0, f1 at k; f0, f1 at k + 1)."""
    key, (v0e, v0o, v1e, v1o) = hashgrid_slab._bwd_streams(xn, g, hcfg)
    return key, torch.stack([v0e, v1e, v0o, v1o])


def brick_stream(xn, g, hcfg) -> tuple:
    """The brick backward's stream of xn and g as brick_table_grad takes
    it: keys (L, n) and 8 planes."""
    key, vals = hashgrid_brick._bwd_streams(xn, g, hcfg)
    return key, torch.stack(vals)


def aggregation_inputs(n: int, L: int, dev) -> dict:
    """Positions in [0, 1]^3 and output gradients (N, 2L) made for the warp
    aggregation of the table-gradient kernels (torch.Generator seed 9):
    every sample in one cell with positive gradients (every warp one
    group; each entry's terms of one sign, so its order bound is 2 (n - 1)
    2^-24 of the entry itself, and a group sum that left out lanes would
    fail it); samples spread uniformly (hardly any group); runs of 8
    samples on one point with every third sample's gradient zero (groups
    with zero-gradient members); rays of 64 samples 2^-10 apart, cut to a
    length that is a multiple neither of the kernels' 64-sample tile nor
    of 32 (nor of the slab stream's 128); and single samples, 1 and 33,
    spread uniformly."""
    gen = torch.Generator(device=dev).manual_seed(9)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    g = torch.randn((n, 2 * L), generator=gen, device=dev)
    k = torch.arange(n, device=dev)
    n_rays = -(-n // 64)
    d = torch.randn((n_rays, 3), generator=gen, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    o = 0.25 + 0.5 * u(n_rays, 3)
    ray = (o[k // 64] + d[k // 64] * ((k % 64)[:, None] * 2.0**-10)
           ).clamp(0.0, 1.0)
    m = n - 13
    return {
        "one cell, positive gradients": (u(1, 3).expand(n, 3).contiguous(),
                                         g.abs()),
        "uniform": (u(n, 3), g),
        "runs of 8, zero-gradient members": (
            u(-(-n // 8), 3)[k // 8].contiguous(),
            torch.where((k % 3 == 0)[:, None], 0.0, g).contiguous()),
        f"rays, ragged length {m}": (ray[:m].contiguous(),
                                     g[:m].contiguous()),
        **{f"uniform, n = {k}": (u(k, 3), g[:k].contiguous())
           for k in (1, 33)},
    }


def aggregation_checks(hcfg, n: int, dev) -> dict:
    """brick3_table_grad and the stream kernels (tcnn on the dedup path's
    corner-major stream, slab and brick on the streams their backwards
    build) against their plain twins, under the same summation-order
    bound, on each stream of aggregation_inputs. Returns {kernel row key:
    [check records]}."""
    T = hcfg.table_size

    def stream_err(name, keys, vals):
        err, tol, _ = stream_grad_err(name, keys, vals, T, stream_table_grad(
            name, keys, vals, T))
        return err, tol

    errs = {
        "brick3_table_grad": lambda x, g: brick3_grad_err(
            x, g, hcfg, hashgrid_table_grad_brick3(x, g, hcfg)),
        "hashgrid_table_grad_window": lambda x, g: stream_err(
            "tcnn_table_grad", *tcnn_stream(*hashgrid_indices_cm(x, hcfg),
                                            g)),
        "sorted_table_grad_window_pair": lambda x, g: stream_err(
            "slab_table_grad", *slab_stream(x, g, hcfg)),
        "sorted_table_grad_brick": lambda x, g: stream_err(
            "brick_table_grad", *brick_stream(x, g, hcfg)),
    }
    recs = {key: [] for key in errs}
    for case, (x, g) in aggregation_inputs(n, hcfg.n_levels, dev).items():
        at = f"aggregation stream: {case}"
        for key, err_fn in errs.items():
            e, t = err_fn(x, g)
            torch.cuda.synchronize()
            check(bool((e <= t).all()), f"{key} kernel vs plain at {at}: "
                                        f"max|diff| {float(e.max())}")
            recs[key].append({
                "at": at, "check": ORDER_CHECK,
                "shape": f"{x.shape[0]} samples",
                "max_abs_err": float(e.max()),
                "max_err_over_tol": float((e / t.clamp_min(1e-30)).max())})
            print(f"[aggregation] {key} at {at} ({x.shape[0]} samples): "
                  f"{ORDER_CHECK} ok, max|diff| {float(e.max()):.3g}, "
                  f"{recs[key][-1]['max_err_over_tol']:.3g} of its bound")
    return recs


def forward_times(table, xn, hcfg) -> dict:
    """Median ms of each family's forward at one microbatch's samples:
    the PyTorch gathers of the tcnn hash (bf16 and f32), slab ('plain'
    and the dedup forward over its addressing) and brick, beside the
    brick3 kernel."""
    packed = pack_brick3_table(table)
    fwds = {
        "tcnn bf16 (window, dedup, sort, pallas, xla)":
            lambda: hashgrid_encode(table, xn, hcfg, torch.bfloat16),
        "tcnn f32 (every f32 run)":
            lambda: hashgrid_encode(table, xn, hcfg, torch.float32),
        "slab plain": lambda: hashgrid_slab.hashgrid_encode_slab_fwd_impl(
            table, xn, hcfg),
        "slab dedup": lambda: hashgrid_encode_dedup_fwd_impl(
            table, xn, hcfg, torch.bfloat16, addr="slab"),
        "brick": lambda: hashgrid_brick.hashgrid_encode_brick_fwd_impl(
            table, xn, hcfg),
        "brick3 (kernel 1, packed)": lambda: hashgrid_encode_brick3_fwd_impl(
            table, xn, hcfg, packed=packed),
        "brick3 (kernel 1, f32 table)":
            lambda: hashgrid_encode_brick3_fwd_impl(table, xn, hcfg),
    }
    out = {k: median_ms(f, reps=10, warmup=2) for k, f in fwds.items()}
    print(f"[forwards] {xn.shape[0]} samples, L={hcfg.n_levels}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items()))
    return out


def print_check(name: str, rec: dict) -> None:
    extra = (f", {rec['max_err_over_tol']:.3g} of its bound"
             if "max_err_over_tol" in rec else "")
    if "zero_fill_ms" in rec:
        extra += f", zero-fill {rec['zero_fill_ms']:.4f} ms"
    if "device_ms" in rec:
        lib = rec["library_device_ms"]
        extra += (f"; on the device (CUDA graph) {rec['device_ms']:.4f} ms, "
                  f"library {'none' if lib is None else f'{lib:.4f} ms'}")
    if "exact_share" in rec:
        extra += (f", exact share {rec['exact_share']:.6f} packed / "
                  f"{rec['exact_share_f32']:.6f} f32; train path (f32 "
                  f"table) {rec['train_path_device_ms']:.4f} ms on the "
                  f"device, bound {rec['train_path_bound_ms']:.4f} ms; "
                  f"the pack alone {rec['pack_device_ms']:.4f} ms")
    if "contract_ms" in rec:
        extra += (f", contract {rec['contract']} in "
                  f"{rec['contract_ms']:.4f} ms")
    print(f"[kernels] {name} at {rec['at']}: {rec['check']} ok (max|diff| "
          f"{rec['max_abs_err']:.3g}{extra}) on {rec['shape']}; median "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
          f"{rec['library_ms']}, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of fn without the host time between calls:
    `reps` calls captured in a CUDA graph, one replay timed by CUDA
    events, divided by reps. (An event pair around a single call of a
    ~10 us kernel also counts the wrapper's Python and ctypes time.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                              # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gather_check(name: str, fn, plain, library, args, n_bytes: int,
                 shape: str, edge_args=None,
                 edges: str = "rows from the end and outside the table, "
                              "lanes outside [0, 128)") -> dict:
    """A gather kernel of the examples against its plain twin (must be
    bit-equal, as 32-bit words so that NaN rows compare, on the script's
    draw and, where given, on its edge draw), with the times of the
    kernel's wrapper, of the twin and of one PyTorch call for the same
    gather, the wrapper's and the library call's device time alone
    (graph_ms), and the bytes bound."""
    errs = []
    for draw in (args, edge_args) if edge_args is not None else (args,):
        got, ref = fn(*draw), plain(*draw)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
              f"{name} kernel != plain twin")
        # NaN - NaN where both gathered NaN: bit-equal there
        diff = (got.double() - ref.double()).abs().nan_to_num(nan=0.0)
        errs.append(float(diff.max()))
    rec = {
        "at": "examples (the script's default size)", "check": "bit-equal",
        "max_abs_err": max(errs), "shape": shape,
        "ms": median_ms(lambda: fn(*args)),
        "device_ms": graph_ms(lambda: fn(*args)),
        "plain_ms": median_ms(lambda: plain(*args)),
        "library_ms": median_ms(library),
        "library_device_ms": graph_ms(library),
    }
    if edge_args is not None:
        rec["edge_check"] = f"bit-equal on the edge draw (with_edges: {edges})"
    rec.update(bound(n_bytes, 0))
    return rec


def vmem_gather_checks(E: int, R: int, dev) -> dict:
    """tal_sublane and rowgather_onehot through their wrappers on the
    script's draw and its edge draw, at E words from an (R, 128) table,
    keyed by the kernel the wrapper launches at this R."""
    x = tvg.make_inputs(E, R, dev)
    edges = tvg.with_edges(x, R)
    tbl, rows_l = x["tbl"], x["rows2d"].long()
    flat_l = ((x["row"].long() << 7) | x["lane"].long()).reshape(-1)
    idx_bytes = E * 4                                  # one int32 index each
    tal = tvg.tal_kernel(R)
    recs = {
        tal: gather_check(
            tal, tvg.tal_sublane, tvg.tal_sublane_plain,
            # take_along_axis over the rows (int64 indices, as torch takes)
            lambda: torch.gather(tbl, 0, rows_l), (tbl, x["rows2d"]),
            R * 128 * 4 + idx_bytes + E * 4,
            f"E={E} words from a ({R}, 128) int32 table",
            (tbl, edges["rows2d"])),
        "rowgather_onehot": gather_check(
            "rowgather_onehot", tvg.rowgather_onehot,
            tvg.rowgather_onehot_plain,
            lambda: torch.take(tbl, flat_l), (tbl, x["row"], x["lane"]),
            R * 128 * 4 + 2 * idx_bytes + E * 4,
            f"E={E} words (row, lane) from a ({R}, 128) int32 table",
            (tbl, edges["row"], edges["lane"])),
    }
    for rec in recs.values():
        rec["at"] = f"examples (the script's default E, R = {R})"
    return recs


def examples_phase(dev) -> tuple:
    """Phase 8: bench_vmem_gather (at its default table and at
    WIDE_ROWS, too large for tal_sublane to stage) and proto_pallas_gather
    run at their default sizes (their kernels' launches counted), then
    each of their five kernels against its plain twin at those sizes
    (rowgather_onehot at both tables); then profile_step at its
    defaults. Returns ({kernel: check record}, launch counts of the
    scripts' runs, profile_step's times)."""
    E, R = tvg.ELEMS, tvg.R
    T, M = tpg.T, tpg.M
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tvg.run(E, R, device=dev)
    tvg.run(E, WIDE_ROWS, device=dev)
    tpg.run(T, M, device=dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    print(f"[examples] launches of the scripts' runs: {launches}")

    recs = vmem_gather_checks(E, R, dev)
    wide = vmem_gather_checks(E, WIDE_ROWS, dev)
    recs["tal_sublane_l2"] = wide["tal_sublane_l2"]
    # rowgather_onehot has one kernel for any R: the wide table's check
    # stands beside the default one
    rec = recs["rowgather_onehot"]
    rec["wide_table"] = wide["rowgather_onehot"]
    rec["max_abs_err"] = max(rec["max_abs_err"],
                             rec["wide_table"]["max_abs_err"])
    p = tpg.make_inputs(T, M, dev)
    table, idx, vals = p["table"], p["idx"], p["vals"]
    recs["pallas_gather"] = gather_check(
        "pallas_gather", tpg.pallas_gather, tpg.pallas_gather_plain,
        lambda: torch.index_select(table, 0, idx), (table, idx),
        M * 4 + M * 8 + T * 8, f"M={M} rows from a ({T}, 2) f32 table",
        (table, tpg.with_edges(p, T)["idx"]),
        "indices from the end and outside the table")

    got = tpg.pallas_scatter(idx, vals, T)
    ref = tpg.pallas_scatter_plain(idx, vals, T)
    tol = tpg.scatter_order_bound(idx, vals, T)
    err = (got - ref).abs()
    torch.cuda.synchronize()
    check(bool((err <= tol).all()), f"pallas_scatter kernel vs plain: "
                                    f"max|diff| {float(err.max())}")
    rec = recs["pallas_scatter"] = {
        "at": "examples (the script's default size)",
        "check": "within 2 (n - 1) 2^-24 sum|terms| per entry (atomic "
                 "summation order)",
        "max_abs_err": float(err.max()),
        "max_err_over_tol": float((err / tol.clamp_min(1e-30)).max()),
        "shape": f"M={M} (row, 2) updates into a ({T}, 2) f32 table",
        "ms": median_ms(lambda: tpg.pallas_scatter(idx, vals, T)),
        # the zero-fill and the atomics
        "device_ms": graph_ms(lambda: tpg.pallas_scatter(idx, vals, T)),
        "plain_ms": median_ms(lambda: tpg.pallas_scatter_plain(idx, vals,
                                                               T)),
        "library_ms": median_ms(lambda: torch.zeros(
            (T, 2), device=dev).index_add_(0, idx, vals)),
        "library_device_ms": graph_ms(lambda: torch.zeros(
            (T, 2), device=dev).index_add_(0, idx, vals)),
    }
    # idx and vals read once, the table written once; two f32 adds an update
    rec.update(bound(M * 4 + M * 8 + T * 8, 2 * M))
    for name, r in recs.items():
        print_check(name, r)
    print_check("rowgather_onehot", recs["rowgather_onehot"]["wide_table"])
    del p, table, idx, vals, got, ref, tol, err

    t0 = time.perf_counter()
    prof = profile_step.run(device=dev)
    print(f"[examples] profile_step at its defaults in "
          f"{time.perf_counter() - t0:.1f} s")
    return recs, launches, {k: 1e3 * v for k, v in prof.items()}


def microbatch(trainer) -> dict:
    """One 2048-ray microbatch (draws from seed 7) of the trainer's
    current parameters, grids and budget: the union march's lattice
    candidates (xyz, dt) and union grid, its marched samples xn in
    [0, 1]^3, and a random output gradient g on the valid slots, zero
    elsewhere (as the path gives)."""
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
    m, _ = march_rays_union_flat(
        rays_o, rays_d, t1, t2, state["occ"], mcfg, batch["noise"],
        budget_per_ray=trainer.rcfg.budget_per_ray,
        cap_scale=trainer.cfg.n_experts)
    rid = m["ray_id"].long()
    x = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])
    xn = ((x - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
          ).clamp(0.0, 1.0).contiguous()
    g = torch.randn((xn.shape[0], 2 * hcfg.n_levels), generator=gen,
                    device=dev)
    return {"xyz": xyz, "dt": dt, "mcfg": mcfg,
            "occ_union": state["occ"].any(dim=0).contiguous(), "xn": xn,
            "g": torch.where(m["valid"][:, None], g, 0.0).contiguous(),
            "n_valid": int(m["total"])}


def microbatch_checks(trainer, at: str, streams: bool = False) -> dict:
    """Kernels 1-3 against their plain versions at one training
    microbatch's shapes (`microbatch`): kernel 2 on the lattice
    candidates, kernels 1 and 3 on the marched samples and gradient; with
    `streams`, also kernels 4-7 and the forwards' times on the same
    samples and gradient. Returns {kernel name or contract: check record}
    (and "forward_ms")."""
    b = microbatch(trainer)
    hcfg = trainer.cfg.hash
    xn, g, n_valid = b["xn"], b["g"], b["n_valid"]
    table = trainer.bundle["model"]["hash_table"].detach()
    recs = {
        "occ_lookup": occ_check(b["xyz"], b["dt"], b["occ_union"],
                                b["mcfg"], at),
        "brick3_encode_fwd": encode_check(
            table, pack_brick3_table(table), xn, hcfg, at, n_valid),
        "brick3_table_grad": table_grad_check(xn, g, hcfg, at, n_valid),
    }
    if streams:
        recs.update(stream_checks(xn, g, hcfg, at))
    for name, rec in recs.items():
        print_check(name, rec)
    if streams:
        recs["forward_ms"] = forward_times(table, xn, hcfg)
    return recs


def encode_times(trainer, label: str) -> dict:
    """The trainer's hash encode alone at one microbatch of its current
    state, as the step runs it (differentiable, no pre-packed table):
    median ms of the forward and of the backward (the table gradient:
    corners computed again, the stream built, the kernel)."""
    b = microbatch(trainer)
    cfg = trainer.cfg
    table = trainer.bundle["model"]["hash_table"].detach().requires_grad_()

    def fwd():
        return encode_dispatch(table, b["xn"], cfg.hash, cfg.cdtype,
                               cfg.hash_impl)

    out = fwd()
    g = b["g"].to(out.dtype)
    rec = {"samples": b["xn"].shape[0],
           "forward_ms": median_ms(fwd, reps=10, warmup=2),
           "backward_ms": median_ms(lambda: torch.autograd.grad(
               out, table, g, retain_graph=True), reps=10, warmup=2)}
    print(f"[{label}] the {cfg.hash_impl} encode alone at one microbatch "
          f"({rec['samples']} samples, budget "
          f"{trainer.rcfg.budget_per_ray}): forward {rec['forward_ms']:.3f} "
          f"ms, backward {rec['backward_ms']:.3f} ms")
    return rec


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


def ray_store(cfg: MNGPConfig, dev) -> dict:
    """The training phases' ray store and its target colours."""
    t0 = time.perf_counter()
    store = sphere_store(STORE_IMAGES, STORE_SIDE, dev)
    store["rays"] = render_sphere(store, cfg)
    torch.cuda.synchronize()
    n_rays = store["rays"].shape[0] * store["rays"].shape[1]
    print(f"[train] ray store: {n_rays} rays ({STORE_IMAGES} cameras x "
          f"{STORE_SIDE}x{STORE_SIDE}), targets rendered in "
          f"{time.perf_counter() - t0:.1f} s; mean colour "
          f"{float(store['rays'].mean()):.4f}")
    return store


def new_trainer(cfg: MNGPConfig, store: dict, dev):
    """A trainer at TrainConfig's defaults from seeds 1 (weights) and 2
    (draws), with empty grids."""
    tcfg = tt.TrainConfig()
    gen = torch.Generator().manual_seed(1)
    trainer = tt.Trainer(cfg, tcfg, init_mngp(gen, cfg, device=dev),
                         init_ray_gate(gen, cfg.n_experts, device=dev),
                         init_mngp_state(cfg, device=dev), store,
                         torch.Generator(device=dev).manual_seed(2))
    check(tcfg.n_microbatch == 4, "batch 8192 must take 4 microbatches")
    return trainer


def fit(trainer, n_steps: int, label: str) -> tuple:
    """n_steps of Trainer.fit_steps, the launch counts reset just before
    and read just after. Returns (launch counts, summary): train rays/s
    (median over the steps after the first 16), PSNR of the first and
    last 16 steps, the last loss, the budget and the seconds."""
    tcfg = trainer.tcfg
    log, secs = [], []
    t_last = [0.0]
    every = max(n_steps // 10, 1)

    def on_step(step, loss, aux):
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs.append(now - t_last[0])
        t_last[0] = now
        log.append({"loss": float(loss), "psnr": float(aux["psnr"])})
        if step % every == 0 or step == n_steps - 1:
            print(f"[{label}] step {step}: loss {log[-1]['loss']:.5f} psnr "
                  f"{log[-1]['psnr']:.2f} budget "
                  f"{trainer.rcfg.budget_per_ray} util "
                  f"{float(aux['budget_util']):.3f} occupied "
                  f"{float(trainer.model_state['occ'].float().mean()):.4f}")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_last[0] = t0 = time.perf_counter()
    trainer.fit_steps(n_steps, on_step)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    rates = [tcfg.batch_size / s for s in secs[16:]]
    psnrs = [r["psnr"] for r in log]
    first, last = float(np.mean(psnrs[:16])), float(np.mean(psnrs[-16:]))
    print(f"[{label}] {n_steps} steps of {tcfg.batch_size} rays in "
          f"{total:.1f} s; train rays/s median {np.median(rates):.0f} over "
          f"steps 16-{n_steps - 1} (min {min(rates):.0f}, max "
          f"{max(rates):.0f}); psnr {first:.2f} -> {last:.2f} dB (mean of "
          f"the first and last 16 steps); budget "
          f"{trainer.rcfg.budget_per_ray}; launches {launches}")
    check(all(np.isfinite([r["loss"] for r in log])),
          f"non-finite training loss ({label})")
    return launches, {
        "steps": n_steps, "rays_per_s": float(np.median(rates)),
        "psnr_first": first, "psnr_last": last,
        "loss_last": log[-1]["loss"],
        "budget_per_ray": trainer.rcfg.budget_per_ray, "seconds": total}


def check_launches(launches: dict, cfg: MNGPConfig, n_steps: int,
                   mb: int, label: str) -> None:
    """Exact launch counts of a training run: the family's table-gradient
    kernel and the occupancy kernel once per microbatch, the brick3
    encode kernel once per microbatch and once per expert and cascade of
    each grid update (brick3 only), every other kernel never."""
    family = cfg.hash_impl if cfg.cdtype == torch.bfloat16 else "dedup"
    n_updates = -(-n_steps // tt.UPDATE_INTERVAL)
    want = {name: 0 for name in launches}
    want["occ_lookup"] = mb * n_steps
    want[FAMILY_KERNELS[family]] = mb * n_steps
    if family == "brick3":
        want["brick3_encode_fwd"] = (
            mb * n_steps + n_updates * cfg.n_experts * cfg.cascades)
    check(launches == want, f"{label} launches {launches}, expected {want}")


def train_phase(cfg: MNGPConfig, store: dict, dev) -> tuple:
    """Phase 5, brick3 at full width. Returns ({kernel or contract: its
    check records at training shapes}, launch counts of the TRAIN_STEPS
    steps, summary)."""
    trainer = new_trainer(cfg, store, dev)
    trainer.update_grid(warmup=True)        # the state a first step sees
    checks = microbatch_checks(
        trainer, f"train step 0 (budget {trainer.rcfg.budget_per_ray})",
        streams=True)
    forwards = checks.pop("forward_ms")
    checks = {name: [rec] for name, rec in checks.items()}
    for key, recs in aggregation_checks(cfg.hash, AGG_SAMPLES, dev).items():
        checks[key] += recs
    checks["brick3_encode_fwd"].append(grid_update_check(trainer))
    trainer.model_state = init_mngp_state(cfg, device=dev)

    launches, summary = fit(trainer, TRAIN_STEPS, "train")
    check(summary["psnr_last"] > summary["psnr_first"] + 3.0,
          f"psnr did not rise: {summary}")
    mb = trainer.tcfg.n_microbatch
    check_launches(launches, cfg, TRAIN_STEPS, mb, "brick3 training")

    for name, rec in microbatch_checks(
            trainer, f"train step {TRAIN_STEPS} (budget "
                     f"{trainer.rcfg.budget_per_ray})").items():
        checks[name].append(rec)
    summary["profile"] = profile_call(
        lambda: trainer.train_step(tt.sample_batch(
            trainer.gen, trainer.data, trainer.tcfg.batch_size)),
        f"one training step ({trainer.tcfg.batch_size} rays, {mb} "
        f"microbatches)")
    summary["forward_ms"] = forwards
    summary["encode_ms"] = encode_times(trainer, "train")
    train_vs_cpu(trainer)
    return checks, launches, summary


def family_phase(cfg: MNGPConfig, store: dict, dev, n_steps: int,
                 label: str, profile: bool = False,
                 pin_forward: bool = False) -> tuple:
    """A fresh trainer of cfg's family trained n_steps steps: finite
    losses, exact launch counts, optionally a profiled step, and a 256-ray
    card-vs-CPU step (see train_vs_cpu for `pin_forward`).
    Returns (trainer, launch counts, summary)."""
    t0 = time.perf_counter()
    trainer = new_trainer(cfg, store, dev)
    launches, summary = fit(trainer, n_steps, label)
    mb = trainer.tcfg.n_microbatch
    check_launches(launches, cfg, n_steps, mb, label)
    if profile:
        summary["profile"] = profile_call(
            lambda: trainer.train_step(tt.sample_batch(
                trainer.gen, trainer.data, trainer.tcfg.batch_size)),
            f"one {label} training step ({trainer.tcfg.batch_size} rays, "
            f"{mb} microbatches)")
    summary["encode_ms"] = encode_times(trainer, label)
    summary["vs_cpu"] = train_vs_cpu(trainer, label=label,
                                     pin_forward=pin_forward)
    summary["phase_seconds"] = time.perf_counter() - t0
    return trainer, launches, summary


def leaf_report(paths, card, cpu, scale: dict | None = None) -> list:
    """Per gradient leaf: max|card - cpu| / max|cpu| (or / scale[path]
    where given), the index of its worst entry and the two values
    there."""
    rows = []
    for path, a, c in zip(paths, card, cpu):
        d = (a - c).abs().reshape(-1)
        k = int(d.argmax())
        ref = (scale or {}).get(path, float(c.abs().max()))
        rows.append({
            "leaf": path,
            "ratio": float(d[k]) / max(ref, 1e-30),
            "at": [int(i) for i in np.unravel_index(k, tuple(a.shape))],
            "card": float(a.reshape(-1)[k]), "cpu": float(c.reshape(-1)[k])})
    return rows


class StepProbe:
    """What one training step's render computes on its way, seen through
    models/mlp.py's layer_tap and a pass-through wrapper of the name
    render/ml_render.py calls for the encode (the step runs the port's own
    code): the encode's features, every MLP input, and each layer's
    product and output before its activation, in call order and named by
    the bundle's MLP they belong to (`bind`; apply_mlp on any other
    parameters fails the check); and the ray gate's output layer, its
    input and (once backward has run) its output's gradient. With `pin` (a
    probe recorded on another device, the same step) the step takes that
    probe's forward: each encode feature, MLP input and layer output is
    replaced by the pinned value (the gradient path stays this device's:
    ref + (h - h)), after measuring how far this device's own value,
    computed from the same (pinned) inputs, lies from it: `feat_equal`;
    per MLP input max |x - ref| / (ulp(x) + 2^-16) and per layer max
    |h - ref| / (ulp(mm) + ulp(h) + 2 K 2^-23 (|x| @ |w|)), both in `gap`
    (see TRAIN_CPU_GRAD_RTOL)."""

    def __init__(self, pin: "StepProbe | None" = None):
        self.feat, self.inputs, self.layers = [], [], []
        self.pin = pin
        self.feat_equal, self.gap = True, []
        self.gate_out, self.names = {}, {}

    def bind(self, bundle) -> None:
        """Name the MLPs of the bundle that the step runs on, by the
        identity of the parameter dicts apply_mlp receives."""
        self.names = {id(bundle["gate"]["encoder"]): "gate",
                      id(bundle["model"]["geo"]): "geo",
                      id(bundle["model"]["rgb"]): "rgb"}

    @staticmethod
    def _pinned(mine: list, pinned: list, key):
        """The pinned probe's record at this call, which must be of the
        same MLP and layer."""
        rec = pinned[len(mine)]
        check(rec[0] == key, f"StepProbe: {key} replayed against {rec[0]}")
        return rec

    @staticmethod
    def _take(h, ref):
        return ref + (h - h.detach())

    def _encode(self, params, state, cfg, xyz, packed=None):
        out = self._encode_fn(params, state, cfg, xyz, packed=packed)
        if self.pin is not None:
            ref = self.pin.feat[len(self.feat)].to(out.device)
            self.feat_equal &= bool(torch.equal(out.detach(), ref))
            out = self._take(out, ref)
        self.feat.append(out.detach())
        return out

    def mlp_input(self, params, x):
        key = self.names.get(id(params))
        check(key is not None, "StepProbe: apply_mlp ran on parameters "
                               "outside the bundle's gate, geo and rgb MLPs")
        if self.pin is not None:
            ref = self._pinned(self.inputs, self.pin.inputs,
                               key)[1].to(x.device)
            xd = x.detach()
            self.gap.append(float(((xd.float() - ref.float()).abs() / (
                bf16_ulp(torch.maximum(xd.abs(), ref.abs()))
                + 2.0**-16)).max()))
            x = self._take(x, ref)
        self.inputs.append((key, x.detach()))
        return x

    def layer(self, params, i, x, mm, out):
        key = (self.names[id(params)], i)
        last = i == len(params["w"]) - 1
        if self.pin is not None:
            _, ref, ref_mm, _ = self._pinned(self.layers, self.pin.layers,
                                             key)
            ref, ref_mm = ref.to(out.device), ref_mm.to(out.device)
            w = params["w"][i].detach().to(x.dtype).float()
            acc = 2 * w.shape[-2] * 2.0**-23 * torch.matmul(
                x.detach().float().abs(), w.abs())
            tol = (bf16_ulp(torch.maximum(mm.detach().abs(), ref_mm.abs()))
                   + bf16_ulp(torch.maximum(out.detach().abs(), ref.abs()))
                   + acc)
            self.gap.append(float(((out.detach().float() - ref.float())
                                   .abs() / tol).max()))
            out = self._take(out, ref)
        if key[0] == "gate" and last:
            self.gate_out = {"layer": i, "x": x.detach()}
            if out.requires_grad:
                out.register_hook(
                    lambda g: self.gate_out.update(grad=g.detach()))
        self.layers.append((key, out.detach(), mm.detach(), not last))
        return out

    @contextlib.contextmanager
    def patched(self):
        self._encode_fn = ml_render_mod._encode
        ml_render_mod._encode = self._encode
        try:
            with layer_tap(self):
                yield self
        finally:
            ml_render_mod._encode = self._encode_fn


def probe_diffs(card: StepProbe, cpu: StepProbe) -> dict:
    """Where the card's forward left the CPU's (each side's own step):
    differing encode features; per MLP layer, differing outputs and
    (hidden layers) flipped ReLU decisions."""
    return {
        "feat_diff": sum(int((x.cpu() != y).sum())
                         for x, y in zip(card.feat, cpu.feat)),
        "layer_diff": [int((x.cpu() != y).sum())
                       for (_, x, _, _), (_, y, _, _) in zip(card.layers,
                                                             cpu.layers)],
        "relu_flips": [int(((x.cpu() > 0) != (y > 0)).sum())
                       for (_, x, _, hid), (_, y, _, _) in zip(card.layers,
                                                               cpu.layers)
                       if hid]}


def cpu_step(trainer, cfg, batch, where, probe: StepProbe | None = None):
    """One CPU_RAYS-ray step of the trainer's parameters and state on
    `where` under cfg: (loss, aux, gradient leaves on the CPU)."""
    move = lambda t: t.detach().to(where)
    bundle = tree_unflatten(trainer.bundle,
                            [move(p) for p in tree_leaves(trainer.bundle)])
    for p in tree_leaves(bundle):
        p.requires_grad_(True)
    state = {k: move(v) for k, v in trainer.model_state.items()}
    data = {k: move(v) for k, v in trainer.data.items()}
    b = {k: move(v) for k, v in batch.items()}
    vg = microbatched_value_and_grad(lambda p, bt: tt.loss_fn(
        p, state, bt, data, cfg, trainer.rcfg, trainer.tcfg), 1)
    if probe is not None:
        probe.bind(bundle)
    with (probe.patched() if probe is not None
          else contextlib.nullcontext()):
        (loss, aux), grads = vg(bundle, b)
    return (float(loss), {k: float(v) for k, v in aux.items()},
            [g.cpu() for g in tree_leaves(grads)])


def train_vs_cpu(trainer, cfg: MNGPConfig | None = None,
                 loss_rtol: float = TRAIN_CPU_LOSS_RTOL,
                 grad_rtol: float = TRAIN_CPU_GRAD_RTOL,
                 label: str = "train", pin_forward: bool = False) -> dict:
    """One 256-ray step at full width on the card and on the CPU (plain
    versions) from the trainer's parameters and state and the same draws
    (seed 3), under `cfg` (default the trainer's): sample counts, loss and
    every gradient leaf, each leaf reported by its path with its worst
    entry; the card's step launches the family's table-gradient kernel
    once. With `pin_forward` (see TRAIN_CPU_GRAD_RTOL) the leaves are held
    against the CPU step that takes the card's forward (StepProbe), once
    the encode features are found equal and every MLP layer output within
    its two bf16 roundings of the CPU's, the gate's output layer at its
    term scale; the card's gate leaves halved must fail that comparison.
    The same on each batch of PIN_SEEDS, further 256-ray batches of the
    same state. Returns the report of every batch."""
    cfg = cfg or trainer.cfg
    dev = trainer.data["directions"].device
    cpu_dev = torch.device("cpu")
    paths = tree_paths(trainer.bundle)
    family = cfg.hash_impl if cfg.cdtype == torch.bfloat16 else "dedup"
    kernel = FAMILY_KERNELS[family]
    report = []
    for seed in (3, *PIN_SEEDS) if pin_forward else (3,):
        batch = tt.sample_batch(
            torch.Generator(device=dev).manual_seed(seed), trainer.data,
            CPU_RAYS)
        pg, pc = (StepProbe(), StepProbe()) if pin_forward else (None, None)
        before = kernels.launch_counts[kernel]
        lg, ag, gg = cpu_step(trainer, cfg, batch, dev, pg)
        check(kernels.launch_counts[kernel] == before + 1,
              f"{label}: the card step did not launch {kernel} once")
        lc, ac, gc = cpu_step(trainer, cfg, batch, cpu_dev, pc)
        leaves = leaf_report(paths, gg, gc)
        top = max(leaves, key=lambda r: r["ratio"])
        rec = {"seed": seed, "loss": [lg, lc],
               "samples": [ag["rm_samples"], ac["rm_samples"]],
               "worst": top["ratio"], "worst_leaf": top["leaf"]}
        checked = leaves
        if pin_forward and ag["rm_samples"] == ac["rm_samples"]:
            pin = StepProbe(pin=pg)
            _, _, gp = cpu_step(trainer, cfg, batch, cpu_dev, pin)
            # the gate's output layer at its term scale (see
            # TRAIN_CPU_GRAD_RTOL), every other leaf at its largest entry
            out = pin.gate_out
            t = out["grad"].float().abs()
            scale = {f"gate/encoder/w/{out['layer']}": float(
                         (out["x"].float().abs().T @ t).max()),
                     f"gate/encoder/b/{out['layer']}": float(t.sum(0).max())}
            checked = leaf_report(paths, gg, gp, scale)
            top = max(checked, key=lambda r: r["ratio"])
            own = {r["leaf"]: r["ratio"] for r in leaf_report(paths, gg, gp)}
            # planted faults: the card's gate leaves halved, all of them
            # (must fail) and each term-scaled leaf alone (reported)
            half = lambda keep: [0.5 * a if keep(p) else a
                                 for p, a in zip(paths, gg)]
            planted = max(r["ratio"] for r in leaf_report(
                paths, half(lambda p: p.startswith("gate/")), gp, scale))
            alone = {r["leaf"]: r["ratio"] for r in leaf_report(
                paths, half(lambda p: p in scale), gp, scale)}
            rec.update(probe_diffs(pg, pc), feat_equal=pin.feat_equal,
                       rounding_gap=max(pin.gap),
                       rounding_gap_at=int(np.argmax(pin.gap)),
                       worst_pinned=top["ratio"],
                       worst_pinned_leaf=top["leaf"],
                       planted_gate_half=planted,
                       gate_out={k: [own[k], scale[k] / max(
                           float(gp[paths.index(k)].abs().max()), 1e-30),
                           alone[k]] for k in scale})
        worst = max(r["ratio"] for r in checked)
        report.append(rec)
        if seed == 3:
            print(f"[{label}] card vs CPU plain, one {CPU_RAYS}-ray step "
                  f"({cfg.hash_impl}, {cfg.compute_dtype}): loss {lg:.6f} "
                  f"vs {lc:.6f}, samples {ag['rm_samples']:.0f} vs "
                  f"{ac['rm_samples']:.0f}, worst gradient leaf max|diff| / "
                  f"max|ref| {rec['worst']:.3g} over {len(gg)} leaves"
                  + (f", {worst:.3g} with the card's forward"
                     if pin_forward else "")
                  + f" (tolerance loss {loss_rtol} relative, leaves "
                  f"{grad_rtol})")
            for r in leaves:
                print(f"[{label}]   leaf {r['leaf']}: {r['ratio']:.3g} at "
                      f"{tuple(r['at'])}, card {r['card']:.6g} vs CPU "
                      f"{r['cpu']:.6g}")
        if pin_forward:
            print(f"[{label}] batch seed {seed}: " + json.dumps(rec))
        check(ag["rm_samples"] == ac["rm_samples"],
              f"{label}: card and CPU marched different samples")
        check(abs(lg - lc) <= loss_rtol * abs(lc),
              f"{label}: card vs CPU loss")
        if pin_forward:
            check(rec["feat_equal"], f"{label}: card and CPU encodes differ")
            check(rec["rounding_gap"] <= 1.0, f"{label}: an MLP output "
                  f"beyond its two bf16 roundings ({rec['rounding_gap']})")
            check(rec["planted_gate_half"] > grad_rtol, f"{label}: the "
                  "card's gate gradient halved passes the check")
        check(worst <= grad_rtol, f"{label}: card vs CPU gradient leaves "
                                  f"(batch seed {seed})")
    return report


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
    print(f"[build] {len(built)} sources ({len(kernels.KERNELS)} kernels) "
          f"in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name, (sec, log) in built.items():
        print(f"[build] {name}: {sec:.1f} s")
        for line in log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"[build]   {line.strip()}")

    scene = render_scene(dev)
    cfg, rcfg, params, gate, state, directions, pose = (
        scene[k] for k in ("cfg", "rcfg", "params", "gate", "state",
                           "directions", "pose"))
    hcfg = cfg.hash
    n_pix = directions.shape[0]

    # 3. kernels vs plain, on the first iteration of the middle chunk
    it = render_iteration(scene)
    c0 = it["c0"]
    at = "render iteration 0"
    table = params["hash_table"]
    render_checks = {
        "occ_lookup": occ_check(it["xyz"], it["dt"], it["occ_union"],
                                it["mcfg"], at),
        "brick3_encode_fwd": encode_check(
            table, pack_brick3_table(table), it["xn"], hcfg, at,
            it["n_valid"]),
    }
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

    # the same 256 rays with hash_impl 'dedup': the tcnn-hash forward in
    # PyTorch, no brick3 table packed and no brick3 kernel launched
    cfg_d = dataclasses.replace(cfg, hash_impl="dedup")
    kernels.reset_launch_counts()
    gpu = render_rays_chunked(params, state, cfg_d, gate, dirs, pose, rcfg,
                              chunk=CPU_RAYS)
    torch.cuda.synchronize()
    dedup_render_launches = dict(kernels.launch_counts)
    cpu = render_rays_chunked(to_cpu(params), to_cpu(state), cfg_d,
                              to_cpu(gate), dirs.cpu(), pose.cpu(), rcfg,
                              chunk=CPU_RAYS)
    diffs = {k: float((gpu[k].cpu() - cpu[k]).abs().max()) for k in CPU_TOL}
    print(f"[render] dedup family, card vs CPU plain on {CPU_RAYS} rays: "
          f"max|diff| {diffs} (tolerance {CPU_TOL}); samples "
          f"{gpu['total_samples']} vs {cpu['total_samples']}; launches "
          f"{dedup_render_launches}")
    for k, tol in CPU_TOL.items():
        check(diffs[k] <= tol, f"dedup render card vs CPU {k}: {diffs[k]}")
    check(gpu["total_samples"] == cpu["total_samples"],
          "dedup render: card and CPU marched different samples")
    check(dedup_render_launches["brick3_encode_fwd"] == 0
          and dedup_render_launches["occ_lookup"] > 0,
          "dedup render launched a brick3 kernel")

    # 5. the training slice at full width
    store = ray_store(cfg, dev)
    train_checks, train_launches, summary = train_phase(cfg, store, dev)
    print(json.dumps({"train": summary}))
    phase_launches = {"render": launches, "train_brick3": train_launches}

    # 6. the dedup family, and one float32 step
    trainer_d, phase_launches["train_dedup"], summary_d = family_phase(
        dataclasses.replace(cfg, hash_impl="dedup"), store, dev,
        DEDUP_STEPS, "dedup", profile=True, pin_forward=True)
    check(summary_d["psnr_last"] > summary_d["psnr_first"] + 3.0,
          f"dedup psnr did not rise: {summary_d}")
    train_vs_cpu(trainer_d, dataclasses.replace(
        cfg, compute_dtype="float32", hash_impl="brick3"),
        TRAIN_CPU_F32_LOSS_RTOL, TRAIN_CPU_F32_GRAD_RTOL, label="float32")
    del trainer_d
    print(json.dumps({"train_dedup": summary_d}))

    # 7. short runs of the slab, brick and pallas families
    for impl in ("slab", "brick", "pallas"):
        _, phase_launches[f"train_{impl}"], summary_f = family_phase(
            dataclasses.replace(cfg, hash_impl=impl), store, dev,
            FAMILY_STEPS, impl)
        print(json.dumps({f"train_{impl}": summary_f}))

    # 8. the examples' gather and scatter kernels, and the step's profile
    example_checks, phase_launches["examples"], profile_ms = examples_phase(
        dev)
    print(json.dumps({"profile_step_ms": profile_ms}))

    # 9. kernels line: per kernel and contract, the launches of the path
    # that runs it (its training phase, or the examples'; every phase's
    # counts under launches_by_path); ms, plain, library and bound at a
    # training step 0 microbatch, the shape of most launches (the
    # examples' kernels: at their scripts' default size); max_abs_err the
    # worst of every check, all in "checks"
    rows = [
        # (check key, kernel, source, replaced Pallas kernel, the wrapper
        # whose contract it keeps, main path)
        ("occ_lookup", "occ_lookup", "occ_lookup.cu",
         "radnerf_tpu/ops/marching.py:312", "occupancy_lookup_bricks",
         "train_brick3"),
        ("brick3_encode_fwd", "brick3_encode_fwd", "brick3_encode_fwd.cu",
         "radnerf_tpu/ops/hashgrid_brick3.py:257",
         "hashgrid_encode_brick3_fwd_impl", "train_brick3"),
        ("brick3_table_grad", "brick3_table_grad", "brick3_table_grad.cu",
         "radnerf_tpu/ops/hashgrid_brick3.py:493",
         "hashgrid_table_grad_brick3", "train_brick3"),
        ("hashgrid_table_grad_window", "tcnn_table_grad",
         "stream_table_grad.cu", "radnerf_tpu/ops/hashgrid_window.py:57",
         "sorted_table_grad_window", "train_dedup"),
        ("sorted_table_grad_window_pair", "slab_table_grad",
         "stream_table_grad.cu", "radnerf_tpu/ops/hashgrid_window.py:244",
         "sorted_table_grad_window_pair", "train_slab"),
        ("sorted_table_grad_brick", "brick_table_grad",
         "stream_table_grad.cu", "radnerf_tpu/ops/hashgrid_brick.py:264",
         "sorted_table_grad_brick", "train_brick"),
        ("hashgrid_table_grad", "tcnn_table_grad", "stream_table_grad.cu",
         "radnerf_tpu/ops/hashgrid_pallas.py:41", "hashgrid_table_grad",
         "train_pallas"),
        ("tal_sublane", "tal_sublane", "vmem_gather.cu",
         "examples/bench_vmem_gather.py:54", "tal_sublane", "examples"),
        ("rowgather_onehot", "rowgather_onehot", "vmem_gather.cu",
         "examples/bench_vmem_gather.py:72", "rowgather_onehot",
         "examples"),
        ("tal_sublane_l2", "tal_sublane_l2", "vmem_gather.cu",
         "examples/bench_vmem_gather.py:54", "tal_sublane", "examples"),
        ("pallas_gather", "pallas_gather", "proto_gather.cu",
         "examples/proto_pallas_gather.py:52", "pallas_gather", "examples"),
        ("pallas_scatter", "pallas_scatter", "proto_gather.cu",
         "examples/proto_pallas_gather.py:84", "pallas_scatter",
         "examples"),
    ]
    recs = []
    for key, name, source, replaces, contract, path in rows:
        n_launch = phase_launches[path][name]
        check(n_launch > 0, f"kernel {name} not launched on {path}")
        runs = train_checks.get(key, []) + [
            checks[key] for checks in (render_checks, example_checks)
            if key in checks]
        main_rec = runs[0]
        recs.append({
            "name": name, "route": "cuda",
            "source": f"radnerf_tpu_torch/csrc/{source}",
            "replaces": replaces, "contract": contract,
            "launches": n_launch, "main_path": path,
            "launches_by_path": {p: c[name]
                                 for p, c in phase_launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in runs),
            **{k: main_rec[k] for k in ("shape", "form", "ms", "device_ms",
                                        "plain_ms", "library_ms",
                                        "library_device_ms", "bound_ms",
                                        "bound_by", "train_path_device_ms",
                                        "train_path_bound_ms",
                                        "pack_device_ms")
               if k in main_rec},
            "checks": runs, "ok": True,
        })
    print(f"[done] {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
