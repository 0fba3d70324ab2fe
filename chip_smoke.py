#!/usr/bin/env python3
"""Drive the PyTorch port's Rad-NeRF MoE test-time render on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure is an uncaught error and a nonzero exit; there is no
CPU fallback):
  1. device: the card's name and power limit, from nvidia-smi;
  2. build: compile every CUDA kernel of the path from csrc/ (nvcc, sm_90a);
  3. kernels vs their plain PyTorch versions on the card, at the shapes of
     the render's first loop iteration on a 4096-ray chunk: the candidate
     occupancy on 4096 x 512 candidates (must be equal), the brick3 encode
     on the iteration's 98,304 marched samples at L=16, T=2^19 (within one
     bf16 ulp); median times of kernel, plain version and library call;
  4. the slice at full width: MNGP zoo=2 (scale 0.5, T=2^19, G=128, bf16,
     brick3) from torch.Generator seed 0, expert 0 occupying a solid
     0.3-radius sphere and expert 1 its +x half, renders a 400x400 pinhole
     image from radius 1.2 through render_rays_chunked (chunk 4096,
     RenderConfig 128 / 24 / 512), timed three times (median rays/s);
     launch counts are reset just before the first render and read just
     after it; one chunk is profiled (device busy share, top
     kernels); then one 256-ray chunk is rendered again on the card and on
     the CPU (plain versions) and compared;
  5. a JSON line with every kernel's check, launches, times and bound;
  6. the last line: {"ok": true, "device": {...}}.
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
from radnerf_tpu_torch.models.ngp import scene_center_half
from radnerf_tpu_torch.ops.fma import fma32
from radnerf_tpu_torch.ops.hashgrid_brick3 import (
    _OFFS3, LANES, _brick3_row, _encode_plain, _geometry, _patch_lane3,
    brick3_addrs, hashgrid_encode_brick3_fwd_impl, pack_brick3_table,
)
from radnerf_tpu_torch.ops.intersection import scene_near_far
from radnerf_tpu_torch.ops.marching import (
    _occ_flat_index, calc_dt, march_rays_test_flat, occupancy_lookup,
    occupancy_lookup_bricks, sample_lattice,
)
from radnerf_tpu_torch.render.ml_render import get_rays, render_rays_chunked
from radnerf_tpu_torch.render.render import NEAR_DISTANCE, RenderConfig

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
    """Distinct packed-table words the encode of x must read."""
    L, R = cfg.n_levels, cfg.table_size // LANES
    xi, yi, zi, _ = _geometry(x, cfg, list(range(L)))
    words = []
    for a in brick3_addrs(cfg):
        px, py, pz, lane0 = _patch_lane3(xi[a.level], yi[a.level],
                                         zi[a.level])
        base = (a.level * R + _brick3_row(a, px, py, pz, R)) * LANES + lane0
        words += [base + off for off in _OFFS3]
    return int(torch.unique(torch.cat(words)).numel())


def profile_chunk(render) -> None:
    """Where one chunk's render time goes: wall time, summed device kernel
    time (kernels run on one stream, so the sum is the busy time), launch
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
        return
    print(f"[profile] one {CHUNK}-ray chunk: wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
          f"{launches} device kernels")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, n) in top:
        print(f"[profile]   {us / 1e3:8.3f} ms {n:5d}x  {name[:90]}")


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
    n_cand = dt.numel()

    occ_k = occupancy_lookup_bricks(xyz, dt, occ_union, mcfg)
    occ_p = occupancy_lookup(xyz, dt, occ_union, mcfg)
    torch.cuda.synchronize()
    check(torch.equal(occ_k, occ_p), "occ_lookup kernel != plain version")
    flat = _occ_flat_index(xyz, dt, mcfg)
    occ_flat = occ_union.reshape(-1)
    cells = int(torch.unique(flat).numel())
    occ_rec = {
        "name": "occ_lookup", "route": "cuda",
        "source": "radnerf_tpu_torch/csrc/occ_lookup.cu",
        "replaces": "radnerf_tpu/ops/marching.py:312",
        "check": "exact",
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
    occ_rec.update(bound(n_cand * (12 + 4 + 1) + cells, n_cand * 24))

    m = march_rays_test_flat(
        rays_o, rays_d, t1, t2, occ_union, mcfg, t1 >= 0,
        k_block=rcfg.test_k_block, cap_per_ray=rcfg.test_block_samples,
        budget_per_ray=rcfg.test_budget_per_ray,
    )
    rid = m["ray_id"].long()
    xs = fma32(m["ts"][:, None], rays_d[rid], rays_o[rid])
    xn = ((xs - state["xyz_min"]) / (state["xyz_max"] - state["xyz_min"])
          ).clamp(0.0, 1.0).contiguous()
    n_samp = xn.shape[0]
    table = params["hash_table"]
    packed = pack_brick3_table(table)
    enc_k = hashgrid_encode_brick3_fwd_impl(table, xn, hcfg, packed=packed)
    enc_p = _encode_plain(packed, xn, hcfg)
    torch.cuda.synchronize()
    ulps = bf16_ulps(enc_k, enc_p)
    check(ulps <= 1.0, f"brick3_encode_fwd kernel vs plain: {ulps} ulp")
    words = brick3_words_needed(xn, hcfg)
    enc_rec = {
        "name": "brick3_encode_fwd", "route": "cuda",
        "source": "radnerf_tpu_torch/csrc/brick3_encode_fwd.cu",
        "replaces": "radnerf_tpu/ops/hashgrid_brick3.py:257",
        "check": "<= 1 bf16 ulp",
        "max_abs_err": float((enc_k.float() - enc_p.float()).abs().max()),
        "max_ulp": ulps,
        "exact_share": float((enc_k == enc_p).float().mean()),
        "shape": f"{n_samp} samples ({int(m['total'])} valid), "
                 f"L={hcfg.n_levels}, T=2^{hcfg.log2_table_size}",
        "ms": median_ms(lambda: hashgrid_encode_brick3_fwd_impl(
            table, xn, hcfg, packed=packed)),
        "plain_ms": median_ms(lambda: _encode_plain(packed, xn, hcfg)),
        "library_ms": None,
    }
    # x in, 2 bf16 out per (sample, level), the distinct table words read;
    # ~60 f32 operations per (sample, level) (3 fma-floor-sub, 8 weights,
    # 16 multiply-adds)
    enc_rec.update(bound(n_samp * 12 + n_samp * hcfg.n_levels * 4
                         + words * 4, n_samp * hcfg.n_levels * 60))
    for rec in (occ_rec, enc_rec):
        print(f"[kernels] {rec['name']}: {rec['check']} ok "
              f"(max|diff| {rec['max_abs_err']:.3g}) on {rec['shape']}; "
              f"median {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"library {rec['library_ms']}, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})")

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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the render")
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
    profile_chunk(lambda: render_rays_chunked(
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

    # 5. kernels line
    recs = []
    for rec in (occ_rec, enc_rec):
        recs.append({**rec, "launches": launches[rec["name"]], "ok": True})
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
