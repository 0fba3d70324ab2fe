"""Microbenchmark: one fine hash level's forward, 8 scalar gathers a
sample against 2 row gathers and a multi-hot corner extraction (twin of
examples/bench_brick_fetch.py).

At the JAX script's shapes (N = 98,304 samples, a T = 2^19 table of
bf16x2 words as (4096, 128) rows):

  scalar8  8 scalar word gathers a sample, bf16 weights x features
  brick2   2 row gathers a sample (z and z + 1), then a weighted
           multi-hot over the 4 xy-corner lanes of each 128-word row (the
           TPU's way round dynamic lane indexing), reduced over the row

    python -m radnerf_tpu_torch.examples.bench_brick_fetch
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.hashgrid_brick3 import _unpack_bf16
from .common import add_device_arg, device_line, timeit

R, LANES = 4096, 128
N = 98304


def scalar8(tbl_flat, idx8, w8):
    """idx8 (8, N) flat entries, w8 (8, N) f32 corner weights."""
    n = idx8.shape[1]
    lo, hi = _unpack_bf16(tbl_flat[idx8.reshape(-1)].reshape(8, n))
    w = w8.to(torch.bfloat16)
    f0 = (w * lo).sum(0)
    f1 = (w * hi).sum(0)
    return f0.float().sum() + f1.float().sum()


def brick2(tbl, rows2, lane0, w4x2):
    """rows2 (2, N) row ids, lane0 (N,) base lane (lx + 11 ly), w4x2
    (2, 4, N) f32 weights of the 4 xy-corners of each z-row."""
    n = lane0.shape[0]
    out0 = torch.zeros((n,), device=tbl.device)
    out1 = torch.zeros((n,), device=tbl.device)
    lanes = torch.arange(LANES, device=tbl.device)[None, :]
    for zr in range(2):
        lo, hi = _unpack_bf16(tbl[rows2[zr]])                  # (N, 128)
        W = torch.zeros((n, LANES), dtype=torch.bfloat16, device=tbl.device)
        for ci, off in enumerate((0, 1, 11, 12)):
            W = W + torch.where(lanes == (lane0 + off)[:, None],
                                w4x2[zr, ci][:, None].to(torch.bfloat16),
                                torch.zeros((), dtype=torch.bfloat16,
                                            device=tbl.device))
        out0 = out0 + (W * lo).float().sum(1)
        out1 = out1 + (W * hi).float().sum(1)
    return out0.sum() + out1.sum()


def run(n: int = N, n_rows: int = R, device="cuda") -> dict:
    print(device_line(device), flush=True)
    rng = np.random.default_rng(0)

    def dev(a):
        return torch.from_numpy(a).to(device)

    tbl = dev(rng.integers(0, 2**32, (n_rows, LANES),
                           dtype=np.uint32).view(np.int32))
    idx8 = dev(rng.integers(0, n_rows * LANES, (8, n), dtype=np.int64))
    w8 = dev(rng.random((8, n), np.float32))
    rows2 = dev(rng.integers(0, n_rows, (2, n), dtype=np.int64))
    lane0 = dev(rng.integers(0, 116, (n,), dtype=np.int64))
    w4x2 = dev(rng.random((2, 4, n), np.float32))
    out = {}
    t = out["scalar8"] = timeit(lambda: scalar8(tbl.reshape(-1), idx8, w8),
                                device, warmup=1, iters=30)
    print(f"scalar8 : {t * 1e3:7.3f} ms/level  "
          f"({8 * n / t / 1e6:5.0f} M issues/s)")
    t = out["brick2"] = timeit(lambda: brick2(tbl, rows2, lane0, w4x2),
                               device, warmup=1, iters=30)
    print(f"brick2  : {t * 1e3:7.3f} ms/level  "
          f"({2 * n / t / 1e6:5.0f} M row-issues/s)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args = add_device_arg(ap).parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
