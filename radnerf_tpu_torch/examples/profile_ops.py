"""Per-op microbenchmarks of the training path's pieces, each timed
apart at training sizes (twin of examples/profile_ops.py): the brick3
hash encode forward and forward + backward (262,144 points, L=16,
T=2^19: kernels 1 and 3 on the card), the dense training march (2048
rays, 1024 candidates each: kernel 2), the dense compositor forward and
forward + backward (2048 x 128), its row scan (`ops/compositing.py::
cumsum`, summed in a fixed order) beside torch.cumsum on the same
inputs, and the geo MLP forward and forward + backward.

    python -m radnerf_tpu_torch.examples.profile_ops
"""

from __future__ import annotations

import argparse

import torch

from ..models.mlp import apply_mlp, init_mlp
from ..ops.compositing import composite_train, cumsum
from ..ops.hashgrid import HashGridConfig, encode_dispatch, init_hashgrid_table
from ..ops.marching import MarchConfig, march_rays_train
from .common import add_device_arg, device_line, timeit


def bench(out: dict, name: str, fn, device, iters: int) -> float:
    dt = out[name] = timeit(fn, device, warmup=1, iters=iters)
    print(f"{name:40s} {dt * 1e3:9.2f} ms", flush=True)
    return dt


def run(n_pts: int = 262_144, n_rays: int = 2048, samples: int = 128,
        log2_T: int = 19, device="cuda", iters: int = 10) -> dict:
    print(device_line(device), flush=True)
    gen = torch.Generator().manual_seed(0)
    out = {}

    # --- hash grid
    cfg = HashGridConfig.for_scene_scale(0.5, log2_table_size=log2_T)
    table = init_hashgrid_table(gen, cfg, device=device)
    x = torch.rand((n_pts, 3), generator=gen).to(device)

    def enc(t):
        return encode_dispatch(t, x, cfg, torch.bfloat16, "brick3")

    def enc_fwd():
        with torch.no_grad():
            return enc(table)

    def enc_grad():
        t = table.detach().requires_grad_(True)
        return torch.autograd.grad(enc(t).float().sum(), t)[0]

    bench(out, f"hashgrid fwd ({n_pts // 1024}k pts, L{cfg.n_levels} "
               f"T2^{log2_T})", enc_fwd, device, iters)
    bench(out, "hashgrid fwd+bwd", enc_grad, device, iters)

    # --- marching
    mcfg = MarchConfig(scale=0.5, cascades=1, samples_per_ray=samples)
    occ = (torch.rand((1, 128, 128, 128), generator=gen) < 0.11).to(device)
    o = torch.randn((n_rays, 3), generator=gen)
    o = (o / o.norm(dim=1, keepdim=True) * 1.2).to(device)
    d = -o / o.norm(dim=1, keepdim=True)
    t1 = torch.full((n_rays,), 0.7, device=device)
    t2 = torch.full((n_rays,), 1.7, device=device)
    bench(out, f"march ({n_rays} rays, K={mcfg.k_candidates} cand)",
          lambda: march_rays_train(o, d, t1, t2, occ, mcfg), device, iters)

    # --- compositing
    sig = (torch.rand((n_rays, samples), generator=gen) * 10).to(device)
    rgbs = torch.rand((n_rays, samples, 3), generator=gen).to(device)
    deltas = torch.full((n_rays, samples), 0.002, device=device)
    ts = deltas.cumsum(1) + 0.7
    valid = torch.ones((n_rays, samples), dtype=torch.bool, device=device)

    def comp():
        with torch.no_grad():
            return composite_train(sig, rgbs, deltas, ts, valid)["rgb"].sum()

    def comp_grad():
        s = sig.detach().requires_grad_(True)
        return torch.autograd.grad(composite_train(
            s, rgbs, deltas, ts, valid)["rgb"].sum(), s)[0]

    bench(out, f"composite fwd ({n_rays}x{samples})", comp, device, iters)
    bench(out, "composite fwd+bwd", comp_grad, device, iters)

    # the compositor's row scan (sigma * delta) alone, beside torch.cumsum
    # on the same inputs
    sd = sig * deltas

    def scan_grad(scan):
        s = sd.detach().requires_grad_(True)
        return torch.autograd.grad(scan(s).sum(), s)[0]

    def torch_cumsum(v):
        return torch.cumsum(v, dim=-1)

    with torch.no_grad():
        bench(out, f"cumsum fwd ({n_rays}x{samples}, fixed order)",
              lambda: cumsum(sd), device, iters)
        bench(out, "torch.cumsum fwd", lambda: torch_cumsum(sd), device,
              iters)
    bench(out, "cumsum fwd+bwd (fixed order)", lambda: scan_grad(cumsum),
          device, iters)
    bench(out, "torch.cumsum fwd+bwd", lambda: scan_grad(torch_cumsum),
          device, iters)

    # --- MLPs
    geo = init_mlp(gen, 32, 64, 17, 1, device=device)
    feat = torch.randn((n_pts, 32), generator=gen).to(device, torch.bfloat16)

    def mlp():
        with torch.no_grad():
            return apply_mlp(geo, feat, compute_dtype=torch.bfloat16)

    def mlp_grad():
        leaves = [p.detach().requires_grad_(True)
                  for p in geo["w"] + geo["b"]]
        n = len(geo["w"])
        p = {"w": leaves[:n], "b": leaves[n:]}
        return torch.autograd.grad(apply_mlp(
            p, feat, compute_dtype=torch.bfloat16).float().sum(), leaves)

    bench(out, f"geo MLP fwd ({n_pts // 1024}k x 32->64->17)", mlp, device,
          iters)
    bench(out, "geo MLP fwd+bwd", mlp_grad, device, iters)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args = add_device_arg(ap).parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
