"""The test render's share of the card's bf16 peak over the window: the
forward MLP FLOPs of the consumed union samples and of the rays' gate
over the window's wall time."""

from benchmark.reference import roofline


def read(ctx):
    w, ref, m = ctx["window"], ctx["reference"], ctx["model"]
    macs = w["samples"] * ref.flops_per_sample(m) + w["rays"] * \
        ref.flops_per_ray(m)
    return roofline.mfu_pct(roofline.mlp_flops(macs, False), w["seconds"])
