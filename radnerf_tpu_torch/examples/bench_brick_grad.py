"""Microbenchmark: the brick table gradient alone and its pieces at
training sizes (T=2^19, L=16, F=2, N samples) (twin of
examples/bench_brick_grad.py).

  table grad full       hashgrid_table_grad_brick: the stream built in
                        PyTorch, then the brick_table_grad kernel
  stream build          _bwd_streams alone
  build + sort(4xf32)   the stream, then torch.sort of its keys with four
                        value planes (the reference's sort; the port's
                        kernel needs none)

    python -m radnerf_tpu_torch.examples.bench_brick_grad [N]
"""

from __future__ import annotations

import argparse

import torch

from ..ops.hashgrid import HashGridConfig
from ..ops.hashgrid_brick import _bwd_streams, hashgrid_table_grad_brick
from .common import add_device_arg, device_line, timeit


def run(n: int = 262_144, log2_T: int = 19, device="cuda") -> dict:
    print(device_line(device), flush=True)
    cfg = HashGridConfig.for_scene_scale(0.5, log2_table_size=log2_T)
    print(f"# N={n} T=2^{log2_T} L={cfg.n_levels}", flush=True)
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((n, 3), generator=gen).to(device)
    g = (torch.randn((n, cfg.n_levels * cfg.n_features), generator=gen)
         * 1e-3).to(device)

    def full():
        return hashgrid_table_grad_brick(x, g, cfg).sum()

    def streams():
        return sum(v.sum() for v in _bwd_streams(x, g, cfg)[1])

    def sort_only():
        key, v = _bwd_streams(x, g, cfg)
        sk, perm = torch.sort(key, dim=-1)
        sv = torch.stack(v[:4], -1).gather(
            1, perm[..., None].expand(-1, -1, 4))
        return sv[..., 0].sum() + sk.sum()

    out = {}
    for name, f in (("table grad full", full), ("  stream build", streams),
                    ("  build + sort(4xf32)", sort_only)):
        dt = out[name.strip()] = timeit(f, device)
        print(f"{name:24s} {dt * 1e3:8.2f} ms", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=262_144)
    args = add_device_arg(ap).parse_args(argv)
    run(args.n, device=args.device)


if __name__ == "__main__":
    main()
