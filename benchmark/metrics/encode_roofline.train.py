"""The hash encode kernel's (csrc/brick3_encode_fwd.cu) share of its
roofline in training: the span's valid samples and its grid updates'
points (half the cells of each grid) over the kernel's device time."""

from benchmark.reference import roofline, trace


def read(ctx):
    span, m = ctx["span"], ctx["model"]
    points = span["valid"] + span["updates"] * m["n_grids"] * \
        m["density_grid_size"] ** 3 / 2
    return roofline.roofline_pct(
        roofline.encode_cost(points, m["n_levels"]),
        trace.named(span["items"], "brick3_encode_fwd"))
