"""The table-gradient kernel's (csrc/brick3_table_grad.cu) share of its
roofline: the span's valid samples and one table written per step over
the kernel's device time."""

from benchmark.reference import roofline, trace


def read(ctx):
    span, m = ctx["span"], ctx["model"]
    L, T = m["n_levels"], 1 << m["log2_hashmap_size"]
    cost = roofline.table_grad_cost(span["valid"], L, span["steps"] * L * T)
    return roofline.roofline_pct(
        cost, trace.named(span["items"], "brick3_table_grad"))
