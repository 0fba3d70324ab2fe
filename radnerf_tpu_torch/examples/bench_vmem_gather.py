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
XLA's gather. tal_sublane stages each block's 8-lane slice of the table
in shared memory, up to STAGED_MAX_ROWS rows (run's n_rows); a larger
table goes to tal_sublane_l2, which reads it through L2, as
rowgather_onehot does at any size (its table staged across a thread
block cluster measured slower). PyTorch cannot index a uint32 tensor, so
the table is int32 words with the same bits.

    python -m radnerf_tpu_torch.examples.bench_vmem_gather [--elems 4194304]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import kernels
from .common import add_device_arg, device_line, table_rows, timeit

R = 4096          # table rows (R * 128 * 4 B = 2 MB: one fine level)
LANES = 128
ELEMS = 4 * 1024 * 1024     # gathered words
# tal_sublane's largest staged table: 232,448 bytes of shared memory a
# block hold 7264 rows' 8-lane slices (32 bytes a row)
STAGED_MAX_ROWS = 7264


def xla_scalar(tbl_flat: torch.Tensor, idx_flat: torch.Tensor):
    """The baseline: one PyTorch gather of the flat table."""
    return torch.take(tbl_flat, idx_flat)


def tal_sublane_plain(tbl: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of tal_sublane: a row outside the table gives -1
    (0xFFFFFFFF, take_along_axis's fill for an unsigned word)."""
    r, inside = table_rows(rows, tbl.shape[0])
    got = tbl[torch.where(inside, r, 0),
              torch.arange(LANES, device=tbl.device)]
    return torch.where(inside, got, -1)


def rowgather_onehot_plain(tbl: torch.Tensor, row: torch.Tensor,
                           lane: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of rowgather_onehot: a lane outside [0, 128)
    gives 0 (the one-hot sum matches no lane), else a row outside the
    table gives -1."""
    r, inside = table_rows(row, tbl.shape[0])
    c = lane.long()
    hit = (c >= 0) & (c < LANES)
    got = tbl.reshape(-1)[torch.where(inside & hit, (r << 7) | c, 0)]
    return torch.where(hit, torch.where(inside, got, -1), 0)


def tal_kernel(n_rows: int) -> str:
    """tal_sublane's entry point for a table of n_rows rows: the staged
    kernel up to STAGED_MAX_ROWS, the one through L2 above."""
    return "tal_sublane" if n_rows <= STAGED_MAX_ROWS else "tal_sublane_l2"


def _check(tbl: torch.Tensor, *idx: torch.Tensor) -> None:
    if (tbl.dtype != torch.int32 or tbl.dim() != 2 or tbl.shape[1] != LANES
            or tbl.shape[0] == 0):
        raise ValueError(f"tbl must be (R, {LANES}) int32 words, R > 0, "
                         f"got {tuple(tbl.shape)} {tbl.dtype}")
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
    (E / 128, 128) int32 -> (E / 128, 128) int32; a row in [-R, 0) counts
    from the end, -1 for one outside [-R, R). On CUDA tensors the kernel
    picked by R alone (tal_kernel): tal_sublane, the table's 8-lane
    slices staged in shared memory, up to STAGED_MAX_ROWS rows, else
    tal_sublane_l2; on CPU tensors the plain twin."""
    _check(tbl, rows)
    if not tbl.is_cuda:
        return tal_sublane_plain(tbl, rows)
    name = tal_kernel(tbl.shape[0])
    if name == "tal_sublane" and tbl.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned (tal_sublane "
                         "stages it in 16-byte chunks)")
    out = torch.empty_like(rows)
    with torch.cuda.device(tbl.device):
        kernels.launch(name, tbl.data_ptr(), rows.data_ptr(),
                       out.data_ptr(), rows.numel(), tbl.shape[0],
                       torch.cuda.current_stream().cuda_stream)
    return out


def rowgather_onehot(tbl: torch.Tensor, row: torch.Tensor,
                     lane: torch.Tensor) -> torch.Tensor:
    """out[i, k] = tbl[row[i, k], lane[i, k]]: tbl (R, 128) int32 words,
    row and lane (E / 128, 128) int32 -> (E / 128, 128) int32; 0 for a
    lane outside [0, 128), else a row in [-R, 0) counts from the end and
    one outside [-R, R) gives -1. The CUDA kernel (the table read through
    L2) on CUDA tensors, its plain twin on CPU tensors."""
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


def edge_rows(n_rows: int) -> list:
    """Rows at and past either end of an n_rows table: from the end
    (-1, -R, -R/2 - 1), outside (-R - 1, R, R + 3), the first and the
    last."""
    return [-1, -n_rows, -(n_rows // 2) - 1, -n_rows - 1, n_rows,
            n_rows + 3, 0, n_rows - 1]


EDGE_LANES = [-1, LANES, 200, LANES - 1]   # outside [0, 128), and the last


def with_edges(x: dict, n_rows: int) -> dict:
    """make_inputs' indices with the edge rows mixed into every third
    word (rows2d and row) and the edge lanes into every fifth (lane, from
    the second word on), so that some edge lanes meet edge rows."""
    rows = torch.tensor(edge_rows(n_rows), dtype=torch.int32)
    lanes = torch.tensor(EDGE_LANES, dtype=torch.int32)
    out = {"tbl": x["tbl"]}
    for key, vals, start, step in (("rows2d", rows, 0, 3),
                                   ("row", rows, 0, 3),
                                   ("lane", lanes, 1, 5)):
        t = x[key].clone()
        flat = t.view(-1)
        k = flat[start::step].numel()
        flat[start::step] = vals.repeat(k // len(vals) + 1)[:k].to(t.device)
        out[key] = t
    return out


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
