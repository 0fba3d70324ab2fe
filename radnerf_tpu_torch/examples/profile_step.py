"""Split the MoE training step into the times of its parts (twin of
examples/profile_step.py).

At the JAX script's shapes (MNGP zoo=2, scale 0.5, T=2^19, G=128, bf16,
the whole batch of 2048 rays in one slice, flat budget 48, a shell
occupancy) it times:
  - the full step (forward, backward, Adam)
  - forward + backward without Adam; the same with the hash table's and
    with the whole model's gradient stopped (.detach())
  - the flat compositor forward + backward at the stream's shapes
  - the render and loss forward alone
  - the union march alone
  - the hash encode forward and forward + backward alone, for --impl and
    'slab', on a ray-coherent stream of batch x budget samples
  - the geo and rgb MLPs alone
  - the step with the hash encode replaced by a zeros stub ("everything
    else": march, MLPs, compositing, losses, Adam)

    python -m radnerf_tpu_torch.examples.profile_step [--batch 2048]
        [--budget_per_ray 48] [--impl dedup] [--union_factor 1.0]
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from ..losses import nerf_loss, total_loss
from ..models.gates import init_ray_gate
from ..models.mlp import apply_mlp
from ..models.mngp import MNGPConfig, init_mngp, init_mngp_state
from ..models.ngp import scene_center_half
from ..ops.compositing import composite_train_flat
from ..ops.hashgrid import encode_dispatch
from ..ops.intersection import scene_near_far
from ..ops.marching import march_rays_union_flat
from ..parallel.step import tree_leaves, tree_unflatten
from ..render import ml_render
from ..render.ml_render import ml_render_train
from ..render.render import RenderConfig
from .common import add_device_arg, device_line, timeit


def shell_occupancy(cfg: MNGPConfig, device) -> torch.Tensor:
    """The converged-like shell of the bench: cells at radius 0.26-0.3,
    every expert and cascade."""
    g = cfg.grid_size
    lin = (np.arange(g) + 0.5) / g * 2 - 1
    xx, yy, zz = np.meshgrid(lin, lin, lin, indexing="ij")
    rr = np.sqrt(xx**2 + yy**2 + zz**2) * cfg.scale
    shell = (rr < 0.3) & (rr > 0.26)
    return torch.tensor(np.broadcast_to(
        shell[None, None], (cfg.n_experts, cfg.cascades, g, g, g)).copy(),
        device=device)


def build_step(batch: int = 2048, budget_per_ray: int = 48,
               impl: str = "dedup", union_factor: float = 1.0,
               device="cuda", log2_T: int = 19, grid_size: int = 128) -> dict:
    """The bench's model, batch and Adam at random weights: {cfg, rcfg,
    bundle, state, batch, optimizer, loss_fn(bundle) -> loss, step() ->
    loss}, where step is one Adam update of the whole batch (the start
    jitter drawn once, from seed 7)."""
    cfg = MNGPConfig(scale=0.5, grid_size=grid_size, log2_T=log2_T,
                     n_experts=2, compute_dtype="bfloat16", hash_impl=impl)
    # the adopted budget bucket governs the union stream directly (factor
    # 1.0), as under the trainer's adaptive budget
    rcfg = RenderConfig(samples_per_ray=192, layout="flat",
                        budget_per_ray=budget_per_ray,
                        union_budget_factor=union_factor)
    bundle = {"model": init_mngp(torch.Generator().manual_seed(0), cfg,
                                 device=device),
              "gate": init_ray_gate(torch.Generator().manual_seed(1),
                                    cfg.n_experts, device=device)}
    state = {**init_mngp_state(cfg, device=device),
             "occ": shell_occupancy(cfg, device)}
    gen = torch.Generator().manual_seed(0)
    o = torch.randn((batch, 3), generator=gen)
    o = o / o.norm(dim=1, keepdim=True) * 1.2
    tgt = torch.rand((batch, 3), generator=gen) * 0.5 - 0.25
    d = tgt - o
    d = d / d.norm(dim=1, keepdim=True)
    rays = {"rays_o": o.to(device), "rays_d": d.to(device),
            "rgb": torch.rand((batch, 3), generator=gen).to(device)}
    noise = torch.rand(batch, generator=torch.Generator().manual_seed(7)
                       ).to(device)
    leaves = tree_leaves(bundle)
    for p in leaves:
        p.requires_grad_(True)
    optimizer = torch.optim.Adam(leaves, lr=1e-2, eps=1e-15)

    def loss_fn(b):
        out = ml_render_train(b["model"], state, cfg, b["gate"],
                              rays["rays_o"], rays["rays_d"], rays["rays_d"],
                              rcfg, noise=noise)
        return total_loss(nerf_loss(
            out, {"rgb": rays["rgb"]}, lambda_opacity=1e-3,
            lambda_cv_importance=1e-2, lambda_depth_mutual=5e-3))

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(bundle)
        loss.backward()
        optimizer.step()
        return loss

    return {"cfg": cfg, "rcfg": rcfg, "bundle": bundle, "state": state,
            "batch": rays, "optimizer": optimizer, "loss_fn": loss_fn,
            "step": step}


@contextlib.contextmanager
def encode_stubbed():
    """The render's hash encode replaced by zeros that still depend on one
    table entry (so the table keeps a gradient). The render looks the
    name up in its own module: the JAX script patches models.mngp, whose
    name the union-flat render had bound at import, so its stub never
    took effect there."""
    real_encode = ml_render._encode
    ml_render._encode = lambda p, st, c, x, impl=None, packed=None: (
        torch.zeros((x.shape[0], c.hash.out_dim), dtype=torch.bfloat16,
                    device=x.device)
        + p["hash_table"][0, 0, 0].to(torch.bfloat16))
    try:
        yield
    finally:
        ml_render._encode = real_encode


def _grads(loss_fn, bundle):
    """Gradients of loss_fn(bundle) in the leaves that still require
    them."""
    leaves = [p for p in tree_leaves(bundle) if p.requires_grad]
    return torch.autograd.grad(loss_fn(bundle), leaves)


def run(batch: int = 2048, budget_per_ray: int = 48, impl: str = "dedup",
        union_factor: float = 1.0, device="cuda", log2_T: int = 19,
        grid_size: int = 128) -> dict:
    """Print each part's time; return {label: seconds}."""
    print(device_line(device), flush=True)
    s = build_step(batch, budget_per_ray, impl, union_factor, device,
                   log2_T, grid_size)
    cfg, rcfg, bundle, state = s["cfg"], s["rcfg"], s["bundle"], s["state"]
    loss_fn = s["loss_fn"]
    out = {}

    def report(label, fn):
        dt = out[label.strip()] = timeit(fn, device, warmup=2, iters=16)
        print(f"{label} {dt * 1e3:9.2f} ms", flush=True)

    model, gate = bundle["model"], bundle["gate"]
    report("full step         ", s["step"])
    report("fw+bw (no adam)   ", lambda: _grads(loss_fn, bundle))
    report("fw+bw, table sg   ", lambda: _grads(loss_fn, {
        "model": {**model, "hash_table": model["hash_table"].detach()},
        "gate": gate}))
    report("fw+bw, model sg   ", lambda: _grads(loss_fn, {
        "model": tree_unflatten(model, [p.detach()
                                        for p in tree_leaves(model)]),
        "gate": gate}))

    # the flat compositor forward + backward at the stream's shapes
    B = batch * budget_per_ray
    gen = torch.Generator().manual_seed(9)
    sig = (torch.rand((2, B), generator=gen) * 5).to(device)
    rgbv = torch.rand((2, B, 3), generator=gen).to(device)
    delt = torch.full((B,), 1.7e-3, device=device)
    tss = torch.cumsum(torch.full((B,), 1.7e-3, device=device), 0)
    rid = torch.arange(batch, dtype=torch.int32,
                       device=device).repeat_interleave(budget_per_ray)
    offs = torch.arange(batch, dtype=torch.int32,
                        device=device) * budget_per_ray
    capc = torch.full((batch,), budget_per_ray, dtype=torch.int32,
                      device=device)
    validc = torch.ones((2, B), dtype=torch.bool, device=device)
    sig.requires_grad_(True)
    rgbv.requires_grad_(True)

    def comp_fwbw():
        res = composite_train_flat(sig, rgbv, delt, tss, rid, offs, capc,
                                   validc, 1e-4)
        total = (res["rgb"].sum() + res["opacity"].sum() + res["depth"].sum()
                 + res["ws"].sum())
        return torch.autograd.grad(total, (sig, rgbv))

    report("composite fw+bw   ", comp_fwbw)

    def fwd():
        with torch.no_grad():
            return loss_fn(bundle)

    report("render fw only    ", fwd)

    # the union march alone
    mcfg = rcfg.march(cfg)
    o, d = s["batch"]["rays_o"], s["batch"]["rays_d"]
    center, half = scene_center_half(state)
    t1, t2 = scene_near_far(o, d, center, half, 0.01)
    noise = torch.rand(batch, generator=torch.Generator().manual_seed(3)
                       ).to(device)

    def march_only():
        m, member = march_rays_union_flat(
            o, d, t1, t2, state["occ"], mcfg, noise,
            budget_per_ray=budget_per_ray, cap_scale=cfg.n_experts)
        return m["ts"].sum() + member.sum()

    report("union march       ", march_only)

    # the encode alone on a ray-coherent stream of B samples
    ts = torch.linspace(0.7, 1.3, budget_per_ray, device=device).repeat(batch)
    xpts = ((o.repeat_interleave(budget_per_ray, 0)
             + ts[:, None] * d.repeat_interleave(budget_per_ray, 0))
            * 0.5 + 0.5).clamp(0.0, 1.0)
    table = model["hash_table"].detach()
    for enc_impl in (impl, "slab"):
        def enc_fw(enc_impl=enc_impl):
            with torch.no_grad():
                return encode_dispatch(table, xpts, cfg.hash, torch.bfloat16,
                                       enc_impl).float().sum()

        def enc_fwbw(enc_impl=enc_impl):
            t = table.detach().requires_grad_(True)
            f = encode_dispatch(t, xpts, cfg.hash, torch.bfloat16,
                                enc_impl).float().sum()
            return torch.autograd.grad(f, t)[0][0, 0]

        report(f"encode fw [{enc_impl:6s}]", enc_fw)
        report(f"encode fwbw [{enc_impl:6s}]", enc_fwbw)

    # the MLPs alone
    feat = torch.zeros((B, 32), dtype=torch.bfloat16, device=device)
    dirs = torch.zeros((B, 16), dtype=torch.bfloat16, device=device)

    def mlps():
        with torch.no_grad():
            h = apply_mlp(model["geo"], feat, compute_dtype=cfg.cdtype)
            rgb_in = torch.cat([dirs[None].expand(2, -1, -1), h[..., 1:]],
                               dim=-1)
            r = apply_mlp(model["rgb"], rgb_in, out_act="sigmoid",
                          compute_dtype=cfg.cdtype)
            return r.float().sum() + h.float().sum()

    report("geo+rgb MLPs      ", mlps)

    with encode_stubbed():
        report("step, encode stub ", s["step"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--budget_per_ray", type=int, default=48)
    ap.add_argument("--impl", type=str, default="dedup")
    ap.add_argument("--union_factor", type=float, default=1.0)
    args = add_device_arg(ap).parse_args(argv)
    run(args.batch, args.budget_per_ray, args.impl, args.union_factor,
        args.device)


if __name__ == "__main__":
    main()
