"""Prototype: a row gather and a row scatter-add of a (T, 2) f32 table,
PyTorch's calls against the hand-written kernels (twin of
examples/proto_pallas_gather.py).

  XLA gather / XLA scatter-add   the baselines, as PyTorch calls
                                 (index_select, index_add_)
  pallas gather                  csrc/proto_gather.cu's pallas_gather:
                                 one thread a row, one float2 load (two
                                 4-byte loads from a table at an odd
                                 element offset)
  pallas scatter-add             its pallas_scatter: one thread per
                                 update, one 8-byte f32x2 reduction each
                                 (the TPU kernel's serial VMEM loop, in
                                 no fixed order)

Each kernel's result is checked against its plain twin ("correct:"): the
gather bit for bit, the scatter within its f32 order bound.

    python -m radnerf_tpu_torch.examples.proto_pallas_gather
"""

from __future__ import annotations

import argparse

import torch

from .. import kernels
from .common import add_device_arg, device_line, table_rows, timeit

T = 1 << 19
F = 2            # the kernels move a row as one float2
M = 1 << 20      # 1M gathers


def pallas_gather_plain(table: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of pallas_gather: a row outside the table
    gathers NaN, as the kernel does."""
    rows, inside = table_rows(idx, table.shape[0])
    got = table[torch.where(inside, rows, 0)]
    return torch.where(inside[:, None], got, float("nan"))


def pallas_scatter_plain(idx: torch.Tensor, vals: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """Plain PyTorch twin of pallas_scatter: an update to a row outside
    the table is dropped, as the kernel drops it."""
    rows, inside = table_rows(idx, n_rows)
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=vals.device)
    return out.index_put_((rows[inside],), vals[inside], accumulate=True)


def _check(idx: torch.Tensor, rows: torch.Tensor, what: str) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"idx must be (M,) int32, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != F:
        raise ValueError(f"{what} must be (n, {F}) float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.device != idx.device:
        raise ValueError(f"idx and {what} must be on one device")
    if idx.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {idx.device}")
    if idx.is_cuda and not (idx.is_contiguous() and rows.is_contiguous()):
        raise ValueError(f"idx and {what} must be contiguous")


def pallas_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx]: table (T, 2) f32, idx (M,) int32 -> (M, 2) f32; an
    index in [-T, 0) counts from the end, NaN for one outside [-T, T).
    table and idx may be views at any element offset. The CUDA kernel on
    CUDA tensors, its plain twin on CPU tensors."""
    _check(idx, table, "table")
    if not idx.is_cuda:
        return pallas_gather_plain(table, idx)
    out = torch.empty((idx.shape[0], F), dtype=torch.float32,
                      device=idx.device)
    with torch.cuda.device(idx.device):
        kernels.launch("pallas_gather", table.data_ptr(), idx.data_ptr(),
                       out.data_ptr(), idx.shape[0], table.shape[0],
                       torch.cuda.current_stream().cuda_stream)
    return out


def pallas_scatter(idx: torch.Tensor, vals: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """zeros(n_rows, 2) with vals[i] added to row idx[i]: idx (M,) int32,
    vals (M, 2) f32 -> (n_rows, 2) f32; an index in [-n_rows, 0) counts
    from the end, one outside [-n_rows, n_rows) is dropped. idx and vals
    may be views at any element offset. The CUDA kernel on CUDA tensors
    (atomics: the order of the sums varies), its plain twin on CPU
    tensors."""
    _check(idx, vals, "vals")
    if vals.shape[0] != idx.shape[0]:
        raise ValueError(f"vals must have {idx.shape[0]} rows, got "
                         f"{vals.shape[0]}")
    if not idx.is_cuda:
        return pallas_scatter_plain(idx, vals, n_rows)
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        kernels.launch("pallas_scatter", idx.data_ptr(), vals.data_ptr(),
                       out.data_ptr(), idx.shape[0], n_rows,
                       torch.cuda.current_stream().cuda_stream)
    return out


def scatter_order_bound(idx: torch.Tensor, vals: torch.Tensor,
                        n_rows: int) -> torch.Tensor:
    """(n_rows, 2) bound on |a - b| between two f32 sums of each row's n
    terms in different orders: 2 (n - 1) 2^-24 sum|terms| (updates outside
    the table dropped)."""
    dev = vals.device
    rows, inside = table_rows(idx, n_rows)
    idx, vals = rows[inside], vals[inside]
    abs_sum = torch.zeros((n_rows, F), device=dev).index_add_(
        0, idx, vals.abs())
    count = torch.zeros((n_rows, 1), device=dev).index_add_(
        0, idx, torch.ones((idx.shape[0], 1), device=dev))
    return 2 * (count - 1).clamp_min(0) * 2.0**-24 * abs_sum


def make_inputs(n_rows: int = T, m: int = M, device="cuda") -> dict:
    """table (T, 2) ~ N(0, 1), idx (M,) uniform in [0, T), vals (M, 2) ~
    N(0, 1), from torch.Generator seeds 0, 1, 2 (the JAX script's
    PRNGKeys; the draws differ)."""
    def gen(seed):
        return torch.Generator().manual_seed(seed)

    return {
        "table": torch.randn((n_rows, F), generator=gen(0)).to(device),
        "idx": torch.randint(0, n_rows, (m,), generator=gen(1),
                             dtype=torch.int32).to(device),
        "vals": torch.randn((m, F), generator=gen(2)).to(device),
    }


def edge_rows(n_rows: int) -> list:
    """Indices at and past either end of an n_rows table: from the end
    (-1, -T, -T/2 - 1) and outside it (-T - 1, T, T + 3)."""
    return [-1, -n_rows, -n_rows - 1, n_rows, n_rows + 3,
            -(n_rows // 2) - 1]


def with_edges(x: dict, n_rows: int) -> dict:
    """make_inputs' draw with the edge rows mixed into every third index
    (the table and vals kept)."""
    idx = x["idx"].clone()
    k = idx[::3].numel()
    rows = torch.tensor(edge_rows(n_rows), dtype=torch.int32)
    idx[::3] = rows.repeat(k // len(rows) + 1)[:k].to(idx.device)
    return {**x, "idx": idx}


def _size(n: int) -> str:
    return f"{n >> 20}M" if n >= 1 << 20 else f"{n >> 10}k"


def run(n_rows: int = T, m: int = M, device="cuda") -> dict:
    """Print the four calls' times and the two checks; return {label:
    seconds} and the checks. Raises if a check fails."""
    print(device_line(device), flush=True)
    x = make_inputs(n_rows, m, device)
    table, idx, vals = x["table"], x["idx"], x["vals"]
    out = {}

    def bench(name, fn, iters=10):
        dt = out[name] = timeit(fn, device, warmup=1, iters=iters)
        print(f"{name:46s} {dt * 1e3:8.2f} ms  ({m / dt / 1e6:7.1f} M ops/s)",
              flush=True)
        return fn()

    bench(f"XLA gather ({_size(m)} from {_size(n_rows)} x {F})",
          lambda: torch.index_select(table, 0, idx))
    bench("XLA scatter-add", lambda: torch.zeros_like(table).index_add_(
        0, idx, vals))

    got = bench("pallas gather (CUDA, a float2 per row)",
                lambda: pallas_gather(table, idx))
    out["gather_correct"] = torch.equal(got, pallas_gather_plain(table, idx))
    print("  correct:", out["gather_correct"], flush=True)

    got = bench("pallas scatter-add (CUDA, f32x2 reductions)",
                lambda: pallas_scatter(idx, vals, n_rows), iters=3)
    err = (got - pallas_scatter_plain(idx, vals, n_rows)).abs()
    out["scatter_correct"] = bool(
        (err <= scatter_order_bound(idx, vals, n_rows)).all())
    out["scatter_max_abs_err"] = float(err.max())
    print("  correct:", out["scatter_correct"], f"(max|diff| "
          f"{out['scatter_max_abs_err']:.3g}, within 2 (n - 1) 2^-24 "
          f"sum|terms| per row)", flush=True)
    if not (out["gather_correct"] and out["scatter_correct"]):
        raise RuntimeError("a kernel disagrees with its plain twin")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args = add_device_arg(ap).parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
