"""What every example shares: the device flag, the device line a run
starts with, the timer, and how the gathers and the scatter take an
index outside their table."""

from __future__ import annotations

import argparse
import time

import torch


def add_device_arg(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no fallback")
    return ap


def device_line(device) -> str:
    """The card's name (torch.cuda.get_device_name), or 'cpu'. Raises
    where CUDA is asked for and there is none."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(device)


def timeit(fn, device, warmup: int = 2, iters: int = 8) -> float:
    """Seconds per call of fn, averaged over `iters` calls after `warmup`:
    CUDA events around the calls on the card, the host clock on the
    CPU."""
    for _ in range(warmup):
        fn()
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def table_rows(idx: torch.Tensor, n_rows: int):
    """idx as int64 rows, an index in [-n_rows, 0) counted from the end
    of the table (as jnp.take, take_along_axis and .at[].add count it),
    and the mask of the rows inside the table."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n_rows, idx)
    return idx, (idx >= 0) & (idx < n_rows)
