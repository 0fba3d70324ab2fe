"""End-to-end smoke: fit a tiny NGP to an analytic emissive sphere (twin of
examples/smoke_e2e.py).

Drives the public API as a user would: build the field and its occupancy
state, train (render -> loss -> Adam), update the density grid every 16
steps, and report the PSNR of the training batches; rays come from
cameras on a shell of radius 1.2, targets from the analytic sphere
rendered through the same march. With --moe the field is a zoo=2 MNGP
with a ray gate (ml_render_train, union sampling).

The reference renders on its dense (N, S) layout with S = 128; the port
has the flat layout only, and takes it with budget_per_ray = S, so that
every ray keeps its first S occupied samples, as the dense layout does.

    python -m radnerf_tpu_torch.examples.smoke_e2e [--steps 300]
        [--batch 2048] [--moe] [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from ..losses import nerf_loss, total_loss
from ..metrics import psnr
from ..models.gates import init_ray_gate
from ..models.mngp import (
    MNGPConfig, init_mngp, init_mngp_state, mngp_update_density_grids,
)
from ..models.ngp import (
    NGPConfig, init_ngp, init_ngp_state, update_density_grid,
)
from ..parallel.step import tree_leaves
from ..render.ml_render import ml_render_train
from ..render.render import RenderConfig, render_train
from .common import add_device_arg, device_line

DENSITY_THRESHOLD = 0.01 * 1024 / math.sqrt(3)


# ---- analytic ground-truth scene: a soft emissive sphere -----------------
def gt_field(x, d):
    r = torch.linalg.vector_norm(x, dim=-1)
    sigma = 40.0 * (r < 0.3).to(torch.float32)
    color = torch.stack(
        [0.5 + x[:, 0], 0.5 + x[:, 1], 0.5 - x[:, 2]], dim=-1
    ).clamp(0, 1)
    return sigma, color


def sample_rays(gen: torch.Generator, n: int, device):
    """n rays from cameras on a shell of radius 1.2, each through a point
    drawn in [-0.25, 0.25]^3."""
    o = torch.randn((n, 3), generator=gen, device=device)
    o = o / torch.linalg.vector_norm(o, dim=1, keepdim=True) * 1.2
    target = torch.rand((n, 3), generator=gen, device=device) * 0.5 - 0.25
    d = target - o
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return o.contiguous(), d.contiguous()


def build(moe: bool, device, seed: int = 0) -> dict:
    """The field (or zoo=2 MNGP and its gate), an all-occupied grid, the
    render settings, Adam at 1e-2 (eps 1e-15) and the grid update."""
    kw = dict(scale=0.5, grid_size=64, n_levels=8, log2_T=15)
    init_gen = torch.Generator().manual_seed(seed)
    if moe:
        cfg = MNGPConfig(n_experts=2, **kw)
        bundle = {"model": init_mngp(init_gen, cfg, device=device),
                  "gate": init_ray_gate(init_gen, 2, device=device)}
        state = init_mngp_state(cfg, device=device)
        update = mngp_update_density_grids
    else:
        cfg = NGPConfig(**kw)
        bundle = {"model": init_ngp(init_gen, cfg, device=device)}
        state = init_ngp_state(cfg, device=device)
        update = update_density_grid
    state = {**state, "occ": torch.ones_like(state["occ"])}
    leaves = tree_leaves(bundle)
    for p in leaves:
        p.requires_grad_(True)
    gt_cfg = NGPConfig(**kw)
    gt_state = init_ngp_state(gt_cfg, device=device)
    return {
        "cfg": cfg, "bundle": bundle, "state": state, "update": update,
        # the target's grid stays all-occupied
        "gt_cfg": gt_cfg,
        "gt_state": {**gt_state, "occ": torch.ones_like(gt_state["occ"])},
        "rcfg": RenderConfig(samples_per_ray=128, layout="flat",
                             budget_per_ray=128),
        "optimizer": torch.optim.Adam(leaves, lr=1e-2, eps=1e-15),
    }


def run(steps: int = 300, batch: int = 2048, moe: bool = False,
        device="cuda", seed: int = 0) -> dict:
    """Train; print the reference's progress lines. Returns first_psnr,
    last_psnr, rays_per_s, seconds."""
    print(device_line(device), flush=True)
    s = build(moe, device, seed)
    cfg, bundle, rcfg = s["cfg"], s["bundle"], s["rcfg"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def train_step(state):
        rays_o, rays_d = sample_rays(gen, batch, device)
        with torch.no_grad():
            target = render_train(None, s["gt_state"], s["gt_cfg"], rays_o,
                                  rays_d, rcfg, forward_fn=gt_field,
                                  gen=gen)["rgb"]
        if moe:
            out = ml_render_train(bundle["model"], state, cfg,
                                  bundle["gate"], rays_o, rays_d, rays_d,
                                  rcfg, gen=gen)
            ld = nerf_loss(out, {"rgb": target}, lambda_cv_importance=1e-2,
                           lambda_depth_mutual=5e-3)
        else:
            out = render_train(bundle["model"], state, cfg, rays_o, rays_d,
                               rcfg, gen=gen)
            ld = nerf_loss(out, {"rgb": target})
        loss = total_loss(ld)
        s["optimizer"].zero_grad(set_to_none=True)
        loss.backward()
        s["optimizer"].step()
        return loss.detach(), psnr(out["rgb"].detach(), target)

    state = s["state"]
    t0 = time.time()
    first_psnr = last_psnr = None
    for step in range(steps):
        if step % 16 == 0 and step > 0:
            state = s["update"](bundle["model"], state, cfg, gen,
                                DENSITY_THRESHOLD, step < 256)
        loss, p = train_step(state)
        if step == 0:
            first_psnr = float(p)
            print(f"step 0: loss={float(loss):.5f} psnr={first_psnr:.2f} "
                  f"(first step {time.time() - t0:.1f}s)", flush=True)
        if step % 50 == 0 or step == steps - 1:
            last_psnr = float(p)
            print(f"step {step}: loss={float(loss):.5f} "
                  f"psnr={last_psnr:.2f}", flush=True)
    dt = time.time() - t0
    rays_per_s = steps * batch / dt
    print(f"\n{steps} steps in {dt:.1f}s  ->  {rays_per_s:,.0f} rays/s "
          f"(incl. the first step)")
    print(f"PSNR {first_psnr:.2f} -> {last_psnr:.2f}")
    return {"first_psnr": first_psnr, "last_psnr": last_psnr,
            "rays_per_s": rays_per_s, "seconds": dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--moe", action="store_true",
                    help="a zoo=2 MNGP with a ray gate instead of one field")
    args = add_device_arg(ap).parse_args(argv)
    res = run(args.steps, args.batch, args.moe, args.device)
    assert res["last_psnr"] > res["first_psnr"] + 5.0, \
        "training did not converge"
    print("SMOKE PASS")
    return res


if __name__ == "__main__":
    main()
