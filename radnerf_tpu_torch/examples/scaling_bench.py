"""Data-parallel scaling harness: rays/s against the number of ranks (twin
of examples/scaling_bench.py).

Times the MoE training step (ray gate, union flat render, nerf_loss with
the opacity, cv and depth-mutual terms, the all-reduce, Adam) on 1..N
ranks with the ray batch scaled with them (weak scaling: each rank keeps
--batch_per_device rays). A count above 1 runs that many ranks of this
host, one a card (parallel.launch); on the CPU, gloo ranks.

    python -m radnerf_tpu_torch.examples.scaling_bench \
        [--batch_per_device 512] [--device_counts 1,2]

Prints one JSON line per count:
    {"devices": d, "rays_per_s": r, "efficiency_vs_1": e}
The counts default to the powers of two up to the local cards (one on
the CPU). Ranks that share the host's CPU time the path, not a card's
scaling.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..losses import nerf_loss, total_loss
from ..models.gates import init_ray_gate
from ..models.mngp import MNGPConfig, init_mngp, init_mngp_state
from ..parallel.mesh import launch, local_device_count, make_mesh
from ..parallel.step import make_train_step, shard_batch, tree_leaves
from ..render.ml_render import ml_render_train
from ..render.render import RenderConfig
from .common import add_device_arg, device_line


def global_batch(n_rays: int, device) -> dict:
    """n_rays rays from radius 1.2 through points in [-0.25, 0.25]^3,
    target colours and the start jitter, from seed 0 (the same on every
    rank)."""
    rng = np.random.default_rng(0)
    o = rng.normal(size=(n_rays, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.2
    d = rng.uniform(-0.25, 0.25, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    b = {"rays_o": o, "rays_d": d, "rgb": rng.uniform(0, 1, (n_rays, 3)),
         "noise": rng.uniform(0, 1, n_rays)}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in b.items()}


def rank_rays_per_s(d: int, batch_per_device: int, experts: int,
                    log2_T: int, grid: int, budget_per_ray: int,
                    steps: int, device) -> float:
    """One rank of a d-rank run: the MoE step on this rank's block of a
    d x batch_per_device batch, one step to warm up, then `steps` steps
    timed; the whole batch's rays per second."""
    mesh = make_mesh(d, device)
    dev = mesh.device
    cfg = MNGPConfig(scale=0.5, grid_size=grid, log2_T=log2_T,
                     n_experts=experts, compute_dtype="bfloat16")
    rcfg = RenderConfig(layout="flat", budget_per_ray=budget_per_ray,
                        samples_per_ray=128)
    params = init_mngp(torch.Generator().manual_seed(0), cfg, device=dev)
    gate = init_ray_gate(torch.Generator().manual_seed(1), cfg.n_experts,
                         device=dev)
    state = init_mngp_state(cfg, device=dev)
    lin = (torch.arange(grid, device=dev) + 0.5) / grid * 2 - 1
    xx, yy, zz = torch.meshgrid(lin, lin, lin, indexing="ij")
    sphere = (xx ** 2 + yy ** 2 + zz ** 2).sqrt() * cfg.scale < 0.3
    state["occ"] = sphere.expand(cfg.n_experts, cfg.cascades, grid, grid,
                                 grid).clone()
    bundle = {"model": params, "gate": gate}
    for p in tree_leaves(bundle):
        p.requires_grad_(True)
    opt = torch.optim.Adam(tree_leaves(bundle), lr=1e-2, eps=1e-15)

    def loss_fn(b, s, batch, data):
        out = ml_render_train(b["model"], s, cfg, b["gate"],
                              batch["rays_o"], batch["rays_d"],
                              batch["rays_d"], rcfg, noise=batch["noise"])
        ld = nerf_loss(out, {"rgb": batch["rgb"]}, lambda_opacity=1e-3,
                       lambda_cv_importance=1e-2, lambda_depth_mutual=5e-3)
        return total_loss(ld), {"psnr": torch.zeros((), device=dev)}

    step = make_train_step(loss_fn, opt, 1, mesh)
    n_rays = batch_per_device * d
    batch = shard_batch(global_batch(n_rays, dev), mesh)
    loss, _ = step(bundle, state, batch, {})
    float(loss)                                   # warm up, and sync
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, _ = step(bundle, state, batch, {})
    float(loss)
    mesh.barrier()
    return steps * n_rays / (time.perf_counter() - t0)


def run(batch_per_device: int = 512, experts: int = 2, log2_T: int = 15,
        grid: int = 64, budget_per_ray: int = 32, steps: int = 8,
        device_counts=None, device="cuda") -> list:
    """The JSON rows, one per rank count (default: powers of two up to
    the local cards)."""
    print(device_line(device), flush=True)
    n_all = local_device_count(device)
    counts = device_counts or [d for d in (1, 2, 4, 8, 16, 32, 64)
                               if d <= n_all]
    print(f"# devices available: {n_all}", flush=True)
    rows, base = [], None
    for d in counts:
        args = (d, batch_per_device, experts, log2_T, grid, budget_per_ray,
                steps, device)
        rps = (launch(d, rank_rays_per_s, args, device=device) if d > 1
               else rank_rays_per_s(*args))
        if base is None:
            base = rps / d
        row = {"devices": d, "rays_per_s": round(rps, 1),
               "efficiency_vs_1": round(rps / (base * d), 3)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch_per_device", type=int, default=512)
    ap.add_argument("--experts", type=int, default=2)
    ap.add_argument("--log2_T", type=int, default=15)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--budget_per_ray", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device_counts", type=str, default="",
                    help="comma list; default = powers of 2 up to all")
    add_device_arg(ap)
    a = ap.parse_args(argv)
    counts = ([int(c) for c in a.device_counts.split(",")]
              if a.device_counts else None)
    return run(a.batch_per_device, a.experts, a.log2_T, a.grid,
               a.budget_per_ray, a.steps, counts, a.device)


if __name__ == "__main__":
    main()
