"""Microbenchmark: hash-grid table-gradient strategies and their pieces at
training sizes (T=2^19, L=16, F=2) (twin of examples/bench_scatter.py).

  - the forward gather alone
  - forward + backward with autograd's scatter-add, the point-major
    kernel (hashgrid_encode_fused), the sort family and the window
    family (both the corner-major tcnn_table_grad kernel on the card)
  - the sort path's pieces in PyTorch: torch.sort with and without
    payloads, cumsum, index_add_ of scalars and of F=2 rows (sorted), the
    tcnn_table_grad kernel alone on the sorted stream, gathers sorted and
    unsorted, sort -> gather -> unsort, and row gathers of width 2, 16, 64

    python -m radnerf_tpu_torch.examples.bench_scatter [N_points]
"""

from __future__ import annotations

import argparse

import torch

from ..ops.hashgrid import hashgrid_encode, hashgrid_indices
from ..ops.hashgrid_pallas import hashgrid_encode_fused
from ..ops.hashgrid_sort import hashgrid_encode_sort
from ..ops.hashgrid_window import hashgrid_encode_window, sorted_table_grad_window
from .bench_hashgrid import fwbw, table_and_samples
from .common import add_device_arg, device_line, timeit


def run(n: int = 196_608, log2_T: int = 19, device="cuda") -> dict:
    print(device_line(device), flush=True)
    cfg, table, x = table_and_samples(n, log2_T, device)
    L, T = cfg.n_levels, cfg.table_size
    n_upd = L * n * 8
    print(f"# N={n} T=2^{log2_T} L={L} -> {n_upd / 1e6:.1f}M updates",
          flush=True)
    out = {}

    def report(name, fn):
        dt = out[name.strip()] = timeit(fn, device)
        print(f"{name:34s} {dt * 1e3:9.2f} ms  ({n_upd / dt / 1e6:8.1f} M "
              f"upd/s)", flush=True)

    def fwd():
        with torch.no_grad():
            return hashgrid_encode(table, x, cfg, torch.bfloat16).float().sum()

    report("fw only (xla gather)", fwd)
    for name, f in (("xla scatter", hashgrid_encode),
                    ("pallas RMW", hashgrid_encode_fused),
                    ("sort-based", hashgrid_encode_sort),
                    ("sorted-window", hashgrid_encode_window)):
        report(f"fw+bw ({name})", lambda f=f: fwbw(
            lambda t, xx: f(t, xx, cfg, torch.bfloat16), table, x))

    # the sort path's pieces on the (L, 8N) point-major stream
    idx, w = hashgrid_indices(x, cfg)
    keys = idx.reshape(L, n * 8).long()
    v = w.reshape(L, n * 8).float()

    payloads = torch.stack([v, v], -1)                  # (L, 8N, 2)

    def sort3():            # the keys' order applied to two payloads
        _, perm = torch.sort(keys, dim=-1)
        return payloads.gather(1, perm[..., None].expand(-1, -1, 2)).sum()

    report("  lax.sort (1 key + 2 payload)", sort3)
    report("  lax.sort (key only)", lambda: torch.sort(keys, dim=-1)[0].sum())
    report("  cumsum", lambda: torch.cumsum(v, dim=-1).sum())

    sk = torch.sort(keys, dim=-1)[0]
    flat_sk = (torch.arange(L, device=sk.device)[:, None] * T + sk).reshape(-1)
    v_flat = v.reshape(-1)
    report("  scatter-add scalar (sorted)", lambda: torch.zeros(
        L * T, device=v.device).index_add_(0, flat_sk, v_flat).sum())
    v2 = torch.stack([v_flat, v_flat], -1)
    report("  scatter-add F=2 rows (sorted)", lambda: torch.zeros(
        (L * T, 2), device=v.device).index_add_(0, flat_sk, v2).sum())
    sk32 = sk.int()
    report("  window-scatter kernel alone",
           lambda: sorted_table_grad_window(sk32, v, v, T).sum())

    # gathers (forward-path candidates)
    tb = table[:, :, 0].contiguous()                    # (L, T) f32
    report("  gather scalar (unsorted)",
           lambda: tb.gather(-1, keys).sum())
    report("  gather scalar (sorted hint)", lambda: tb.gather(-1, sk).sum())
    rows = table.reshape(L * T, 2)
    report("  gather F=2 rows (sorted hint)", lambda: rows[flat_sk].sum())

    def fw_sorted_pipeline():
        sk_, perm = torch.sort(keys, dim=-1)
        vals = tb.gather(-1, sk_)
        _, back = torch.sort(perm, dim=-1)      # sort back by sample id
        return vals.gather(-1, back).sum()

    report("  fw sort->gather->unsort", fw_sorted_pipeline)

    # wide-row gathers: rows/s against the row width
    ridx = torch.randint(0, T, (n * 8,),
                         generator=torch.Generator().manual_seed(3)).to(device)
    for width in (2, 16, 64):
        src = torch.randn((T, width), generator=torch.Generator().manual_seed(
            2)).to(device=device, dtype=torch.bfloat16)
        dt = out[f"gather rows width {width}"] = timeit(
            lambda src=src: src[ridx].float().sum(), device)
        print(f"  gather {n * 8 / 1e6:.1f}M rows width {width:3d}      "
              f"{dt * 1e3:9.2f} ms  ({n * 8 / dt / 1e6:8.1f} M rows/s)",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=196_608)
    args = add_device_arg(ap).parse_args(argv)
    run(args.n, device=args.device)


if __name__ == "__main__":
    main()
