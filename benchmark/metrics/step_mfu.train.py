"""The whole step's share of the card's bf16 peak over the measured
window: the MLP FLOPs the window's valid samples and rays need (forward
2, backward 4 per multiply-add) over the window's wall time."""

from benchmark.reference import roofline


def read(ctx):
    w, ref, m = ctx["window"], ctx["reference"], ctx["model"]
    macs = w["valid"] * ref.flops_per_sample(m) + w["rays"] * \
        ref.flops_per_ray(m)
    return roofline.mfu_pct(roofline.mlp_flops(macs, True), w["seconds"])
