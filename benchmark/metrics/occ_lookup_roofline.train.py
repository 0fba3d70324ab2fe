"""The occupancy kernel's (csrc/occ_lookup.cu) share of its roofline in
training: the candidates of the span's marches (rays x lattice
candidates) over the kernel's device time in the traced span."""

from benchmark.reference import roofline, trace
from benchmark.reference.nerf import Field


def read(ctx):
    span, w = ctx["span"], ctx["window"]
    rays_per_step = w["rays"] / w["steps"]
    n = span["steps"] * rays_per_step * Field(ctx["model"]).k_candidates
    return roofline.roofline_pct(roofline.occ_lookup_cost(n),
                                 trace.named(span["items"], "occ_lookup"))
