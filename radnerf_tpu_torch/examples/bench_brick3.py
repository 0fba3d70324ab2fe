"""Microbenchmark: the brick encode (xy patch, 2 rows a sample) against
brick3 (cube, 1 row a sample) at training shapes, forward and forward +
backward, on a ray-ordered sample stream and on a random one (twin of
examples/bench_brick3.py).

brick's forward is PyTorch gathers and its backward the brick_table_grad
kernel; brick3's forward is the brick3_encode_fwd kernel (its 'plain' and
'runs' modes are one kernel on the card) and its backward the
brick3_table_grad kernel.

    python -m radnerf_tpu_torch.examples.bench_brick3 [N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.hashgrid_brick import hashgrid_encode_brick
from ..ops.hashgrid_brick3 import hashgrid_encode_brick3
from .bench_hashgrid import fwbw, table_and_samples
from .common import add_device_arg, device_line, timeit


def ray_stream(n: int, seed: int = 1, samples_per_ray: int = 48):
    """A ray-ordered stream on the dt_min lattice, like the flat training
    layout: (n, 3) f32 positions in [0, 1]^3 (numpy draws)."""
    rng = np.random.default_rng(seed)
    n_rays = n // samples_per_ray
    o = rng.normal(size=(n_rays, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.1
    d = -o + rng.normal(size=(n_rays, 3)) * 0.05
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    dt = 2.0 * np.sqrt(3.0) / 1024.0
    t0 = 0.4 + rng.random(n_rays)[:, None] * 0.2
    t = t0 + np.arange(samples_per_ray)[None, :] * dt
    pts = (o[:, None] + t[:, :, None] * d[:, None]).reshape(-1, 3)
    pts = np.clip(pts * 0.45 + 0.5, 1e-3, 1 - 1e-3)[:n]
    return torch.tensor(pts, dtype=torch.float32)


def run(n: int = 196_608, log2_T: int = 19, device="cuda") -> dict:
    print(device_line(device), flush=True)
    cfg, table, _ = table_and_samples(n, log2_T, device)
    xs = {"ray": ray_stream(n).to(device),
          "rand": torch.rand((n, 3), generator=torch.Generator().manual_seed(
              2)).to(device)}
    print(f"# N={n} T=2^{log2_T} L={cfg.n_levels}")
    variants = {
        "brick  (2-row)": lambda t, x: hashgrid_encode_brick(
            t, x, cfg, torch.bfloat16),
        "brick3 (plain)": lambda t, x: hashgrid_encode_brick3(
            t, x, cfg, fw_mode="plain"),
        "brick3 (runs) ": lambda t, x: hashgrid_encode_brick3(
            t, x, cfg, fw_mode="runs"),
    }
    out = {}
    for sname, x in xs.items():
        for name, f in variants.items():
            def fwd(f=f, x=x):
                with torch.no_grad():
                    return f(table, x).float().sum()

            tf = timeit(fwd, device)
            tg = timeit(lambda f=f, x=x: fwbw(f, table, x), device)
            out[f"{sname} {name.strip()}"] = {"fw": tf, "fw+bw": tg}
            print(f"{sname:5s} {name}: fw {tf * 1e3:7.2f} ms   "
                  f"fw+bw {tg * 1e3:7.2f} ms", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=196_608)
    args = add_device_arg(ap).parse_args(argv)
    run(args.n, device=args.device)


if __name__ == "__main__":
    main()
