"""Valid samples the march kept per training ray over the window (the
union of the experts' samples for the MoE): a count of work."""


def read(ctx):
    w = ctx["window"]
    return w["valid"] / w["rays"] if w["rays"] else None
