"""The hash encode kernel's share of its roofline in the test render:
the union samples the span consumed over the kernel's device time."""

from benchmark.reference import roofline, trace


def read(ctx):
    span, m = ctx["span"], ctx["model"]
    return roofline.roofline_pct(
        roofline.encode_cost(span["samples"], m["n_levels"]),
        trace.named(span["items"], "brick3_encode_fwd"))
