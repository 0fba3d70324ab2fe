"""Microbenchmark: word gathers from one fine level's packed table (twin
of examples/bench_vmem_gather.py).

Gathers E words from an (R, 128) table of 32-bit words (R = 4096: 2 MB,
one T = 2^19 level packed as bf16x2):

  xla_scalar        the baseline: torch.take on the flat table
  tal_sublane       out[i, j] = tbl[rows[i, j], j] (the lane fixed), the
                    CUDA kernel of csrc/vmem_gather.cu
  rowgather_onehot  the general gather tbl.flat[row * 128 + lane], the
                    same source's second kernel

The TPU script asked whether a table staged in VMEM gathers faster than
XLA's gather; the port's kernels gather straight from global memory, the
table held in L2. PyTorch cannot index a uint32 tensor, so the table is
int32 words with the same bits.

    python -m radnerf_tpu_torch.examples.bench_vmem_gather [--elems 4194304]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import kernels
from .common import add_device_arg, device_line, timeit

R = 4096          # table rows (R * 128 * 4 B = 2 MB: one fine level)
LANES = 128
ELEMS = 4 * 1024 * 1024     # gathered words


def xla_scalar(tbl_flat: torch.Tensor, idx_flat: torch.Tensor):
    """The baseline: one PyTorch gather of the flat table."""
    return torch.take(tbl_flat, idx_flat)


def tal_sublane_plain(tbl: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of tal_sublane."""
    return tbl[rows.long(), torch.arange(LANES, device=tbl.device)]


def rowgather_onehot_plain(tbl: torch.Tensor, row: torch.Tensor,
                           lane: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of rowgather_onehot."""
    return tbl.reshape(-1)[(row.long() << 7) | lane.long()]


def _check(tbl: torch.Tensor, *idx: torch.Tensor) -> None:
    if tbl.dtype != torch.int32 or tbl.dim() != 2 or tbl.shape[1] != LANES:
        raise ValueError(f"tbl must be (R, {LANES}) int32 words, got "
                         f"{tuple(tbl.shape)} {tbl.dtype}")
    for t in idx:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != LANES:
            raise ValueError(f"indices must be (E / {LANES}, {LANES}) int32, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.shape != idx[0].shape or t.device != tbl.device:
            raise ValueError("indices must share one shape and the table's "
                             "device")
    if tbl.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no gather for device {tbl.device}")
    if tbl.is_cuda and not all(t.is_contiguous() for t in (tbl, *idx)):
        raise ValueError("table and indices must be contiguous")


def tal_sublane(tbl: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out[i, j] = tbl[rows[i, j], j]: tbl (R, 128) int32 words, rows
    (E / 128, 128) int32 -> (E / 128, 128) int32. The CUDA kernel on CUDA
    tensors, its plain twin on CPU tensors."""
    _check(tbl, rows)
    if not tbl.is_cuda:
        return tal_sublane_plain(tbl, rows)
    out = torch.empty_like(rows)
    with torch.cuda.device(tbl.device):
        kernels.launch("tal_sublane", tbl.data_ptr(), rows.data_ptr(),
                       out.data_ptr(), rows.numel(), tbl.shape[0],
                       torch.cuda.current_stream().cuda_stream)
    return out


def rowgather_onehot(tbl: torch.Tensor, row: torch.Tensor,
                     lane: torch.Tensor) -> torch.Tensor:
    """out[i, k] = tbl[row[i, k], lane[i, k]]: tbl (R, 128) int32 words,
    row and lane (E / 128, 128) int32 -> (E / 128, 128) int32. The CUDA
    kernel on CUDA tensors, its plain twin on CPU tensors."""
    _check(tbl, row, lane)
    if not tbl.is_cuda:
        return rowgather_onehot_plain(tbl, row, lane)
    out = torch.empty_like(row)
    with torch.cuda.device(tbl.device):
        kernels.launch("rowgather_onehot", tbl.data_ptr(), row.data_ptr(),
                       lane.data_ptr(), out.data_ptr(), row.numel(),
                       tbl.shape[0], torch.cuda.current_stream().cuda_stream)
    return out


def make_inputs(elems: int, n_rows: int = R, device="cuda",
                seed: int = 0) -> dict:
    """The script's inputs, the same numpy draws as the JAX script's: the
    table, flat indices, rows for tal_sublane, and flat's (row, lane)."""
    if elems % LANES:
        raise ValueError(f"elems must be a multiple of {LANES}, got {elems}")
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 2**32, (n_rows, LANES), dtype=np.uint32)
    flat = rng.integers(0, n_rows * LANES, (elems,),
                        dtype=np.int64).astype(np.int32)
    rows2d = rng.integers(0, n_rows, (elems // LANES, LANES),
                          dtype=np.int64).astype(np.int32)
    return {
        "tbl": torch.from_numpy(tbl.view(np.int32)).to(device),
        "flat": torch.from_numpy(flat).to(device),
        "rows2d": torch.from_numpy(rows2d).to(device),
        "row": torch.from_numpy((flat >> 7).reshape(-1, LANES)).to(device),
        "lane": torch.from_numpy((flat & 127).reshape(-1, LANES)).to(device),
    }


def run(elems: int = ELEMS, n_rows: int = R, device="cuda",
        iters: int = 20) -> dict:
    """Print the three gathers' times and rates; return {label: seconds}."""
    print(device_line(device), flush=True)
    x = make_inputs(elems, n_rows, device)
    tbl = x["tbl"]
    print(f"# table {n_rows}x{LANES} u32 ({n_rows * LANES * 4 / 2**20:.1f} "
          f"MB), E = {elems / 1e6:.1f}M")
    tbl_flat, flat = tbl.reshape(-1), x["flat"].long()
    calls = {
        "xla_scalar": lambda: xla_scalar(tbl_flat, flat),
        "tal_sublane": lambda: tal_sublane(tbl, x["rows2d"]),
        "rowgather_onehot": lambda: rowgather_onehot(tbl, x["row"],
                                                     x["lane"]),
    }
    out = {}
    for name, fn in calls.items():
        t = out[name] = timeit(fn, device, warmup=1, iters=iters)
        print(f"{name:18s}: {t * 1e3:7.2f} ms  {elems / t / 1e6:7.0f} M/s",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--elems", type=int, default=ELEMS)
    args = add_device_arg(ap).parse_args(argv)
    run(args.elems, device=args.device)


if __name__ == "__main__":
    main()
