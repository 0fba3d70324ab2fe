"""Microbenchmark: gather rate against the width of the gathered slice,
as PyTorch indexing at hash-table scale (T=2^19 words, M issues) (twin
of examples/bench_gather_shapes.py).

  scalar        one word per index                (output (A*128,))
  pair-row      2 consecutive words               (output (A, 2, 128))
  slab22        a 2x2 slice of a (T/128 + 1, 130) padded table
                                                  (output (A, 2, 2, 128))
  cube222       a 2x2x2 slice of a dense (64, 64, 64)
                                                  (output (A, 2, 2, 2, 128))
plus the pair and slab gathers with a multiply-and-reduce consumer, and
the scalar gather of sorted indices. Reports ms, M index issues/s and M
gathered words/s. `--complex` then also times a complex64 scalar gather
against two word gathers.

    python -m radnerf_tpu_torch.examples.bench_gather_shapes [M_issues]
        [--complex]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from .common import add_device_arg, device_line, timeit

T = 1 << 19


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def run(m: int = 4_194_304, device="cuda") -> dict:
    print(device_line(device), flush=True)
    table = torch.randint(0, 1 << 30, (T,), generator=_gen(0),
                          dtype=torch.int32).to(device)
    A = m // 128
    idx = torch.randint(0, T - 200, (A, 128), generator=_gen(1)).to(device)
    out = {}

    def report(name, fn, n_issues, vals_per_issue):
        dt = out[name] = timeit(fn, device, iters=10)
        print(f"{name:28s} {dt * 1e3:8.2f} ms  {n_issues / dt / 1e6:8.1f} M "
              f"iss/s  {n_issues * vals_per_issue / dt / 1e6:9.1f} M u32/s",
              flush=True)

    report("scalar", lambda: table[idx.reshape(-1)].float().sum(), m, 1)

    off2 = torch.arange(2, device=device)
    pair_ix = idx[:, None, :] + off2[None, :, None]            # (A, 2, 128)
    report("pair-row (A,2,128)", lambda: table[pair_ix].float().sum(), m, 2)

    rows = T // 128
    t_slab = F.pad(table.reshape(rows, 128), (0, 2, 0, 1))     # (rows+1, 130)
    q = (idx // 128)[:, None, None, :] + off2[None, :, None, None]
    mm = (idx % 128)[:, None, None, :] + off2[None, None, :, None]
    report("slab22 (A,2,2,128)", lambda: t_slab[q, mm].float().sum(), m, 4)

    W = 64
    t3d = torch.randint(0, 1 << 30, (W, W, W), generator=_gen(2),
                        dtype=torch.int32).to(device)
    c3 = torch.randint(0, W - 1, (A, 128, 3), generator=_gen(3)).to(device)
    cx = c3[..., 0][:, None, None, None, :] + off2[None, :, None, None, None]
    cy = c3[..., 1][:, None, None, None, :] + off2[None, None, :, None, None]
    cz = c3[..., 2][:, None, None, None, :] + off2[None, None, None, :, None]
    report("cube222 (A,2,2,2,128)", lambda: t3d[cx, cy, cz].float().sum(),
           m, 8)

    w = torch.rand((A, 128), generator=_gen(4)).to(device)

    def pair_consume():
        v = table[pair_ix].float()
        lo = v % 65536.0
        return (lo[:, 0] * w + lo[:, 1] * (1 - w)).sum()

    report("pair-row + consume", pair_consume, m, 2)

    def slab_consume():
        v = t_slab[q, mm].float()
        return (v[:, 0, 0] * w + v[:, 0, 1] + v[:, 1, 0] * (1 - w)
                + v[:, 1, 1]).sum()

    report("slab22 + consume", slab_consume, m, 4)

    idx_s = torch.sort(idx.reshape(-1))[0]
    report("scalar sorted-hint", lambda: table[idx_s].float().sum(), m, 1)
    return out


def run_complex(m: int = 4_194_304, device="cuda") -> dict:
    """A complex64 scalar gather (8 bytes an index) against two word
    gathers of (x, x + 1) (after `run`, which printed the device)."""
    tab =torch.randn((T, 2), generator=_gen(0))
    tab_c = torch.complex(tab[:, 0], tab[:, 1]).to(device)
    idx = torch.randint(0, T - 2, (m,), generator=_gen(1)).to(device)
    tab_u = torch.randint(0, 1 << 30, (T,), generator=_gen(2),
                          dtype=torch.int32).to(device)
    out = {}

    def g_c():
        v = tab_c[idx]
        return (v.real + v.imag).sum()

    dt = out["complex64 scalar gather"] = timeit(g_c, device, iters=10)
    print(f"complex64 scalar gather       {dt * 1e3:8.2f} ms "
          f"{m / dt / 1e6:8.1f} M iss/s", flush=True)
    dt = out["2x u32 scalar gathers"] = timeit(
        lambda: (tab_u[idx] + tab_u[idx + 1]).float().sum(), device,
        iters=10)
    print(f"2x u32 scalar gathers         {dt * 1e3:8.2f} ms "
          f"{m / dt / 1e6:8.1f} M pair/s", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("m", type=int, nargs="?", default=4_194_304)
    ap.add_argument("--complex", action="store_true")
    args = add_device_arg(ap).parse_args(argv)
    run(args.m, device=args.device)
    if args.complex:
        run_complex(args.m, device=args.device)


if __name__ == "__main__":
    main()
