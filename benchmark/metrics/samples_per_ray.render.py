"""Union samples the test render consumed per ray over the window."""


def read(ctx):
    w = ctx["window"]
    return w["samples"] / w["rays"]
