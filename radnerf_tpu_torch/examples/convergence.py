"""Convergence runs (twin of examples/convergence.py), each printing a JSON
row per evaluation and one SUMMARY line:

  sphere: an NGP fitted to smoke_e2e's analytic emissive sphere for
      --steps steps, the PSNR of a fixed held-out ray set every
      --eval_every (compute dtypes and hash impls compared by flags);
  hard: a MoE (zoo=2, G=128) on a multi-object, high-frequency analytic
      scene, --render union (one union march and encode) or per_expert
      (each expert its own march), batch in --hard_microbatch slices;
  scene: the single-field NeRFSystem (train.py's) on a small NSVF scene of
      a coloured sphere that the run writes itself (6 training and 2 test
      views at 32x32, PNGs through data/png.py), the validation PSNR of
      the test views every --eval_every.

    python -m radnerf_tpu_torch.examples.convergence sphere --steps 2000 \
        --impl slab --dtype bfloat16 --out curves/sphere_slab_bf16.jsonl
    python -m radnerf_tpu_torch.examples.convergence hard --render \
        per_expert --levels 16 --log2_T 19 --batch 8192
    python -m radnerf_tpu_torch.examples.convergence scene --steps 2000

--eval_rays (default 4096, the reference's) and --device are the port's.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
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
from ..parallel.step import microbatched_value_and_grad, tree_leaves
from ..render.ml_render import ml_render_train
from ..render.render import RenderConfig, render_train
from .common import add_device_arg, device_line
from .smoke_e2e import DENSITY_THRESHOLD, gt_field, sample_rays


def _occupancy(sigma_fn, cfg, dilate: int, device):
    """Occupied cells of an analytic field at the cell centres (dilated
    by `dilate` cells), in every cascade: (C, G, G, G)."""
    from scipy.ndimage import binary_dilation

    G = cfg.grid_size
    lin = (np.arange(G) + 0.5) / G * 2.0 - 1.0
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    pts = np.stack([xx, yy, zz], -1).reshape(-1, 3) * cfg.scale
    occ = sigma_fn(pts).reshape(G, G, G)
    if dilate:
        occ = binary_dilation(occ, iterations=dilate)
    return torch.tensor(np.broadcast_to(occ, (cfg.cascades, G, G, G)).copy(),
                        device=device)


def _adam(bundle):
    leaves = tree_leaves(bundle)
    for p in leaves:
        p.requires_grad_(True)
    return torch.optim.Adam(leaves, lr=1e-2, eps=1e-15)


def _eval_set(args, gt_render):
    """The fixed held-out rays, their start jitter and ground truth."""
    egen = torch.Generator(device=args.device).manual_seed(10_000 + args.seed)
    eo, ed = sample_rays(egen, args.eval_rays, args.device)
    noise = torch.rand(args.eval_rays, device=args.device,
                       generator=torch.Generator(device=args.device)
                       .manual_seed(1))
    return eo, ed, noise, gt_render(eo, ed, noise)


def run_sphere(args):
    cfg = NGPConfig(scale=0.5, grid_size=64, n_levels=args.levels,
                    log2_T=args.log2_T, compute_dtype=args.dtype,
                    hash_impl=args.impl)
    rcfg = RenderConfig(samples_per_ray=128, layout=args.layout,
                        budget_per_ray=64)
    dev = args.device
    params = init_ngp(torch.Generator().manual_seed(args.seed), cfg,
                      device=dev)
    # the ground truth's occupancy (radius 0.3 plus a cell's margin): the
    # target render always uses it, and the model starts from it (an
    # all-occupied grid and the static budget would front-truncate the
    # march before the sphere), refined by the usual grid updates
    G = cfg.grid_size
    occ0 = _occupancy(lambda p: np.linalg.norm(p, axis=-1)
                      < 0.3 + 2.0 * cfg.scale * 2 / G, cfg, 0, dev)
    state = {**init_ngp_state(cfg, device=dev), "occ": occ0}
    gt_state = dict(state)
    opt = _adam(params)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def gt_render(o, d, noise=None):
        with torch.no_grad():
            return render_train(None, gt_state, cfg, o, d, rcfg,
                                forward_fn=gt_field, noise=noise,
                                gen=gen)["rgb"]

    eo, ed, enoise, egt = _eval_set(args, gt_render)

    def eval_row(state):
        with torch.no_grad():
            out = render_train(params, state, cfg, eo, ed, rcfg,
                               noise=enoise)
        return (float(psnr(out["rgb"], egt)),
                float(state["occ"].float().mean()),
                float(out["rm_samples"]) / eo.shape[0])

    rows = []
    t0 = time.time()
    for step in range(args.steps):
        if step % 16 == 0 and step > 0:
            state = update_density_grid(params, state, cfg, gen,
                                        DENSITY_THRESHOLD, step < 256)
        o, d = sample_rays(gen, args.batch, dev)
        target = gt_render(o, d)
        out = render_train(params, state, cfg, o, d, rcfg, gen=gen)
        loss = total_loss(nerf_loss(out, {"rgb": target}))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        loss = loss.detach()
        if step % args.eval_every == 0 or step == args.steps - 1:
            ep, occ_frac, demand = eval_row(state)
            row = {"step": step, "psnr": round(ep, 3),
                   "loss": round(float(loss), 6),
                   "occ_frac": round(occ_frac, 4),
                   "samples_per_ray": round(demand, 1),
                   "t": round(time.time() - t0, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {
        "exp": "sphere", "impl": args.impl, "dtype": args.dtype,
        "layout": args.layout, "steps": args.steps, "batch": args.batch,
        "final_psnr": rows[-1]["psnr"],
        "best_psnr": max(r["psnr"] for r in rows),
        "wall_s": rows[-1]["t"], "device": device_line(dev),
    }
    return rows, summary


HARD_SPHERES = (((-0.22, -0.18, 0.0), 0.14), ((0.24, 0.1, -0.12), 0.17),
                ((-0.05, 0.22, 0.18), 0.11))
HARD_BOX = ((0.1, -0.25, 0.22), 0.09)


def hard_field(x, d):
    """The reference's multi-object, high-frequency analytic scene: three
    spheres and a box (solid sigma 200), each object's hue modulated by
    sine products at 25, 90 and 400 rad per unit."""
    inside = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    obj_id = torch.zeros(x.shape[0], device=x.device)
    for i, (c, r) in enumerate(HARD_SPHERES):
        hit = torch.linalg.vector_norm(
            x - torch.tensor(c, device=x.device), dim=-1) < r
        inside = inside | hit
        obj_id = torch.where(hit, float(i + 1), obj_id)
    c, half = HARD_BOX
    box = ((x - torch.tensor(c, device=x.device)).abs() < half).all(dim=-1)
    inside = inside | box
    obj_id = torch.where(box, 4.0, obj_id)
    sigma = 200.0 * inside.to(torch.float32)
    f1 = torch.sin(25.0 * x[:, 0]) * torch.sin(25.0 * x[:, 1])
    f2 = torch.sin(90.0 * x[:, 1]) * torch.sin(90.0 * x[:, 2])
    f3 = torch.sin(400.0 * x[:, 0]) * torch.sin(400.0 * x[:, 2])
    tex = 0.5 + 0.18 * f1 + 0.18 * f2 + 0.14 * f3
    hue = obj_id / 4.0
    color = torch.stack([tex * (0.4 + 0.6 * hue), tex,
                         tex * (1.0 - 0.5 * hue)], dim=-1).clamp(0.0, 1.0)
    return sigma, color


def _hard_occupied(pts: np.ndarray) -> np.ndarray:
    sig, _ = hard_field(torch.from_numpy(pts.astype(np.float32)), None)
    return sig.numpy() > 0


def run_hard(args):
    """The MoE at G=128 and zoo=2 on the hard scene, batch in
    --hard_microbatch accumulation slices, ray gate, cv 1e-2 and
    depth-mutual 5e-3; --render union|per_expert."""
    dev = args.device
    cfg = MNGPConfig(scale=0.5, grid_size=128, n_levels=args.levels,
                     log2_T=args.log2_T, n_experts=2,
                     compute_dtype=args.dtype, hash_impl=args.impl)
    rcfg = RenderConfig(samples_per_ray=192, layout="flat",
                        budget_per_ray=64,
                        union_sampling=(args.render == "union"))
    init_gen = torch.Generator().manual_seed(args.seed)
    bundle = {"model": init_mngp(init_gen, cfg, device=dev),
              "gate": init_ray_gate(init_gen, 2, device=dev)}
    occ1 = _occupancy(_hard_occupied, cfg, 2, dev)
    gt_cfg = NGPConfig(scale=0.5, grid_size=128, n_levels=args.levels,
                       log2_T=args.log2_T)
    gt_state = {**init_ngp_state(gt_cfg, device=dev), "occ": occ1}
    state = {**init_mngp_state(cfg, device=dev),
             "occ": occ1[None].expand(2, -1, -1, -1, -1).contiguous()}
    opt = _adam(bundle)
    gt_rcfg = RenderConfig(samples_per_ray=192, layout="flat",
                           budget_per_ray=64)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def gt_render(o, d, noise=None):
        with torch.no_grad():
            return render_train(None, gt_state, gt_cfg, o, d, gt_rcfg,
                                forward_fn=hard_field, noise=noise,
                                gen=gen)["rgb"]

    def loss3(b, mb):
        out = ml_render_train(b["model"], state, cfg, b["gate"],
                              mb["rays_o"], mb["rays_d"], mb["rays_d"],
                              rcfg, noise=mb["noise"])
        ld = nerf_loss(out, {"rgb": mb["rgb"]}, lambda_opacity=1e-3,
                       lambda_cv_importance=1e-2, lambda_depth_mutual=5e-3)
        return total_loss(ld), {}

    vg = microbatched_value_and_grad(loss3, max(1, args.hard_microbatch))
    eo, ed, enoise, egt = _eval_set(args, gt_render)

    def eval_row(state):
        with torch.no_grad():
            out = ml_render_train(bundle["model"], state, cfg,
                                  bundle["gate"], eo, ed, ed, rcfg,
                                  noise=enoise)
        return (float(psnr(out["rgb"], egt)),
                float(state["occ"].float().mean()),
                float(out["rm_samples"]) / eo.shape[0])

    rows = []
    t0 = time.time()
    for step in range(args.steps):
        if step % 16 == 0 and step > 0:
            state = mngp_update_density_grids(
                bundle["model"], state, cfg, gen, DENSITY_THRESHOLD,
                step < 256)
        o, d = sample_rays(gen, args.batch, dev)
        batch = {"rays_o": o, "rays_d": d, "rgb": gt_render(o, d),
                 "noise": torch.rand(args.batch, generator=gen, device=dev)}
        (loss, _), grads = vg(bundle, batch)
        for p, g in zip(tree_leaves(bundle), tree_leaves(grads)):
            p.grad = g
        opt.step()
        if step % args.eval_every == 0 or step == args.steps - 1:
            ep, occ_frac, demand = eval_row(state)
            elapsed = max(time.time() - t0, 1e-9)
            row = {"step": step, "psnr": round(ep, 3),
                   "loss": round(float(loss), 6),
                   "occ_frac": round(occ_frac, 4),
                   "samples_per_ray": round(demand, 1),
                   "rays_s": round(args.batch * (step + 1) / elapsed),
                   "t": round(time.time() - t0, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {
        "exp": "hard", "impl": args.impl, "dtype": args.dtype,
        "render": args.render, "steps": args.steps, "batch": args.batch,
        "log2_T": args.log2_T, "levels": args.levels,
        "final_psnr": rows[-1]["psnr"],
        "best_psnr": max(r["psnr"] for r in rows),
        "wall_s": rows[-1]["t"], "device": device_line(dev),
    }
    return rows, summary


def _look_at(eye) -> np.ndarray:
    """(3, 4) camera-to-world looking at the origin (right, down,
    forward), z up."""
    eye = np.asarray(eye, np.float64)
    f = -eye / np.linalg.norm(eye)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r /= np.linalg.norm(r)
    return np.stack([r, np.cross(f, r), f, eye], axis=1)


def write_sphere_scene(parent: str, n_train: int = 6, n_test: int = 2,
                       wh=(32, 32)) -> str:
    """A Synthetic-NSVF scene (bbox.txt, intrinsics.txt, rgb/, pose/) of
    an opaque coloured sphere (radius 0.35, colour 0.5 + position, white
    background), traced on the host and written with data/png.py. The
    loader takes its intrinsics at 800 pixels and --downsample w / 800.
    Returns the scene's root."""
    from ..data.png import write_png

    root = os.path.join(parent, "Synthetic_NeRF", "Sphere")
    for sub in ("rgb", "pose"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    w, h = wh
    focal = 1.2 * w
    scale = w / 800.0
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write(f"{focal / scale} 0 400 0\n0 {focal / scale} 400 0\n"
                "0 0 1 0\n0 0 0 1\n")
    np.savetxt(os.path.join(root, "bbox.txt"),
               [[-0.6, -0.6, -0.6, 0.6, 0.6, 0.6, 0.1]])
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    dirs = np.stack([(u - w / 2) / focal, (v - h / 2) / focal,
                     np.ones_like(u)], -1)
    for split, n in ((0, n_train), (1, n_test), (2, n_test)):
        for i in range(n):
            th = 2 * np.pi * (i + split * 0.33) / n
            c2w = _look_at([1.4 * np.cos(th), 1.4 * np.sin(th),
                            0.7 + 0.2 * split])
            rd = dirs @ c2w[:, :3].T
            rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
            ro = c2w[:, 3]
            b = 2 * (rd @ ro)
            disc = b * b - 4 * (ro @ ro - 0.35**2)
            t = (-b - np.sqrt(np.maximum(disc, 0))) / 2
            hit = (disc > 0) & (t > 0)
            img = np.ones((h, w, 3))
            img[hit] = np.clip(0.5 + ro + t[hit][:, None] * rd[hit], 0, 1)
            name = f"{split}_{i:04d}"
            write_png(os.path.join(root, "rgb", name + ".png"),
                      (img * 255).astype(np.uint8))
            np.savetxt(os.path.join(root, "pose", name + ".txt"),
                       np.vstack([c2w, [0, 0, 0, 1]]))
    return root


def _scene_rows(system, args) -> tuple:
    """Train `system` --steps steps one at a time (the trainer's own grid
    updates and adaptive budget), validating every --eval_every; returns
    (rows, trainer)."""
    system.setup()
    tr = system.trainer
    rows, last = [], {}
    t0 = time.time()
    t_eval = 0.0

    def on_step(step, loss, aux):
        last.update(loss=loss, aux=aux)

    try:
        for step in range(args.steps):
            tr.fit_steps(1, on_step)
            if step % args.eval_every == 0 or step == args.steps - 1:
                te0 = time.time()
                val = system.validate(epoch=0)
                t_eval += time.time() - te0
                train_t = max(time.time() - t0 - t_eval, 1e-9)
                row = {"step": step, "val_psnr": round(val["psnr"], 3),
                       "train_psnr": round(float(last["aux"]["psnr"]), 3),
                       "loss": round(float(last["loss"]), 6),
                       "budget": tr.rcfg.budget_per_ray,
                       "rays_s": round(args.batch * (step + 1) / train_t),
                       "t": round(time.time() - t0, 1)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        system.close()
    return rows, tr


def run_scene(args):
    """train.py's single field through NeRFSystem on write_sphere_scene's
    scene (T=2^15, one epoch of --steps steps), the validation PSNR of the
    test views every --eval_every (validation time left out of rays/s)."""
    from ..opt import get_opts
    from ..train.trainer import NeRFSystem

    with tempfile.TemporaryDirectory(prefix="convergence_scene_") as work:
        root = args.scene_root or write_sphere_scene(work)
        h = get_opts([
            "--root_dir", root, "--dataset_type", "nsvf",
            "--dataset_name", "Synthetic_NeRF", "--scene_name", "Sphere",
            "--exp_name", "convergence", "--downsample", str(32 / 800),
            "--scale", "0.5", "--hash_table_size", "15",
            "--batch_size", str(args.batch), "--num_epochs", "1",
            "--steps_per_epoch", str(args.steps), "--samples_per_ray", "48",
            "--compute_dtype", args.dtype, "--hash_impl", args.impl,
            "--seed", str(args.seed), "--val_chunk", "1024",
            "--no_save_test", "--adaptive_budget" if args.adaptive_budget
            else "--no-adaptive_budget"])
        cwd = os.getcwd()
        os.chdir(work)             # logs/ and ckpts/ go under the work dir
        try:
            rows, tr = _scene_rows(NeRFSystem(h, device=args.device), args)
        finally:
            os.chdir(cwd)
    summary = {
        "exp": "scene", "impl": args.impl, "dtype": args.dtype,
        "steps": args.steps, "batch": args.batch,
        "adaptive_budget": bool(args.adaptive_budget),
        "final_val_psnr": rows[-1]["val_psnr"],
        "best_val_psnr": max(r["val_psnr"] for r in rows),
        "final_budget": tr.rcfg.budget_per_ray,
        "wall_s": rows[-1]["t"], "device": device_line(args.device),
    }
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("exp", choices=["sphere", "scene", "hard"])
    ap.add_argument("--render", type=str, default="union",
                    choices=["union", "per_expert"])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--eval_every", type=int, default=100)
    ap.add_argument("--eval_rays", type=int, default=4096)
    ap.add_argument("--impl", type=str, default="auto")
    ap.add_argument("--dtype", type=str, default="bfloat16")
    ap.add_argument("--layout", type=str, default="flat")
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--log2_T", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene_root", type=str, default=None)
    ap.add_argument("--hard_microbatch", type=int, default=2,
                    help="hard exp: gradient-accumulation slices per step")
    ap.add_argument("--adaptive_budget", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="scene exp: the trainer's --adaptive_budget path "
                         "(default on, as opt.py)")
    ap.add_argument("--out", type=str, default=None)
    args = add_device_arg(ap).parse_args(argv)
    print(device_line(args.device), flush=True)
    runner = {"sphere": run_sphere, "scene": run_scene, "hard": run_hard}
    rows, summary = runner[args.exp](args)
    print("SUMMARY " + json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps({"summary": summary}) + "\n")
    return rows, summary


if __name__ == "__main__":
    main()
