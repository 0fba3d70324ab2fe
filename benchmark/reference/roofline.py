"""The yardstick's arithmetic: the H100's published peaks, the least time
a call could take, and the bytes and operations the program's kernels
need for their inputs (valid samples only; a table's random reads are
not counted, so a share is a lower bound by at most the table's bytes).

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): HBM3
3.35 TB/s, float32 67 TFLOP/s outside the tensor cores, bfloat16 989
TFLOP/s on them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Least seconds: the larger of bytes over the HBM rate and float32
    operations over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def encode_cost(n_points: float, n_levels: int) -> tuple:
    """The hash encode of n points: x in (12 B) and 2 bf16 features out
    per level (4 B); ~60 float32 operations per (point, level): the
    position, 8 weights, 16 multiply-adds."""
    return n_points * (12 + 4 * n_levels), n_points * n_levels * 60


def table_grad_cost(n_points: float, n_levels: int, table_entries: int):
    """The table gradient of n points: x (12 B) and the f32 output
    gradient (8 B a level) in, the f32 table gradient (8 B an entry)
    written once; ~60 operations per (point, level)."""
    return (n_points * (12 + 8 * n_levels) + table_entries * 8,
            n_points * n_levels * 60)


def occ_lookup_cost(n_candidates: float) -> tuple:
    """The occupancy test of n candidates: position and step in (16 B),
    one byte out; ~24 operations each (the cascade, the cell index)."""
    return n_candidates * 17, n_candidates * 24


def roofline_pct(cost: tuple, device_s: float) -> float | None:
    """A kernel's share of its roofline, in %: the least time its work
    needs over the time it took (None where it did not run or had no
    work)."""
    if device_s <= 0 or cost[0] + cost[1] <= 0:
        return None
    return 100.0 * bound_s(*cost) / device_s


def mlp_flops(macs: float, backward: bool) -> float:
    """FLOPs of `macs` multiply-adds: 2 forward, 4 more backward (the
    input and the weight gradients)."""
    return macs * (6.0 if backward else 2.0)


def mfu_pct(flops: float, seconds: float) -> float | None:
    """FLOPs over the seconds against the bf16 tensor-core peak, in %."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / BF16_FLOPS_PER_S
