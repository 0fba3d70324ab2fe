"""The occupancy kernel's share of its roofline in the test render: the
candidates the span's march iterations test (chunk x the test block)
over the kernel's device time."""

from benchmark.reference import roofline, trace

TEST_K_BLOCK = 512          # lattice candidates a test iteration tests


def read(ctx):
    span, w = ctx["span"], ctx["window"]
    n = span["iterations"] * w["chunk"] * TEST_K_BLOCK
    return roofline.roofline_pct(roofline.occ_lookup_cost(n),
                                 trace.named(span["items"], "occ_lookup"))
