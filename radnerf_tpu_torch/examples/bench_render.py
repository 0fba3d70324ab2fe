"""Test-time render throughput (twin of examples/bench_render.py): an
side x side image of rays, in chunks, against a half-converged occupancy
grid (a solid 0.3-radius sphere, ~11% of the cells) with a full-width NGP
field (scale 0.5, G=128, T=2^19, bf16, brick3) from seed 0, comparing

  render_test            (with --plain: the loop on whole chunks; on
                          the dense test layout retired rays keep their
                          lanes)
  render_test_compacted  (the alive rays gathered into a smaller batch
                          every --phase_iters iterations)

on the --layout test layout. Each path is timed twice over the whole
image after one warm-up chunk: `cold`, then `warm`; host clock, the card
synchronized at the ends.

    python -m radnerf_tpu_torch.examples.bench_render [--side 800]
        [--chunk 65536] [--layout flat|dense] [--plain]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models.ngp import NGPConfig, init_ngp, init_ngp_state
from ..render.render import RenderConfig, render_test, render_test_compacted
from .common import add_device_arg, device_line


def sphere_scene(cfg: NGPConfig, device):
    """The field from seed 0 and a state whose occupancy is the solid
    0.3-radius sphere."""
    params = init_ngp(torch.Generator().manual_seed(0), cfg, device=device)
    state = init_ngp_state(cfg, device=device)
    g = cfg.grid_size
    lin = (np.arange(g) + 0.5) / g * 2 - 1
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = np.sqrt(xx**2 + yy**2 + zz**2) * cfg.scale < 0.3
    state["occ"] = torch.from_numpy(np.broadcast_to(
        sphere[None], (cfg.cascades, g, g, g)).copy()).to(device)
    return params, state


def camera_rays(side: int, device):
    """Pinhole rays over the image from radius 1.2, looking at the
    origin."""
    eye = np.array([0.0, -1.2, 0.25], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    u, v = np.meshgrid((np.arange(side) + 0.5) / side - 0.5,
                       (np.arange(side) + 0.5) / side - 0.5)
    dirs = (u[..., None] * right + v[..., None] * down
            + 1.2 * fwd).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rays_d = torch.from_numpy(dirs.astype(np.float32)).to(device)
    rays_o = torch.from_numpy(eye).to(device).expand(side * side, 3)
    return rays_o.contiguous(), rays_d


def run(side: int = 800, chunk: int = 65536, phase_iters: int = 4,
        k_block: int = 256, budget: int = 8, layout: str = "flat",
        plain: bool = False, log2_T: int = 19, device="cuda") -> dict:
    print(device_line(device), flush=True)
    device = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(device)) if (
        device.type == "cuda") else (lambda: None)
    cfg = NGPConfig(scale=0.5, grid_size=128, log2_T=log2_T,
                    compute_dtype="bfloat16", hash_impl="brick3")
    rcfg = RenderConfig(test_layout=layout, test_k_block=k_block,
                        test_budget_per_ray=budget)
    params, state = sphere_scene(cfg, device)
    rays_o, rays_d = camera_rays(side, device)
    n_rays = side * side

    paths = [(f"{layout} + host compaction",
              lambda ro, rd: render_test_compacted(
                  params, state, cfg, ro, rd, rcfg,
                  phase_iters=phase_iters))]
    if plain:
        paths.insert(0, (f"render_test ({layout}, plain)",
                         lambda ro, rd: render_test(params, state, cfg, ro,
                                                    rd, rcfg)))
    out = {}
    for name, render in paths:
        res = render(rays_o[:chunk], rays_d[:chunk])      # warm-up
        sync()
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            total = 0
            for c0 in range(0, n_rays, chunk):
                c1 = min(c0 + chunk, n_rays)
                if c1 - c0 < chunk:
                    break             # the ragged tail is left out
                res = render(rays_o[c0:c1], rays_d[c0:c1])
                total += c1 - c0
            sync()
            dt = time.perf_counter() - t0
            out[f"{name} [{label}]"] = total / dt
            print(f"{name:28s} [{label}] {total / dt:12,.0f} rays/s "
                  f"({dt:.2f}s for {total} rays)", flush=True)
        out[f"{name} opacity"] = float(res["opacity"].mean())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", type=int, default=800)
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--phase_iters", type=int, default=4)
    ap.add_argument("--k_block", type=int, default=256)
    ap.add_argument("--budget", type=int, default=8)
    ap.add_argument("--layout", type=str, default="flat",
                    choices=["flat", "dense"])
    ap.add_argument("--plain", action="store_true",
                    help="also time the loop without compaction")
    args = add_device_arg(ap).parse_args(argv)
    return run(args.side, args.chunk, args.phase_iters, args.k_block,
               args.budget, args.layout, args.plain, device=args.device)


if __name__ == "__main__":
    main()
