"""The share of the traced span's wall time in which no operation ran on
the device, in %."""


def read(ctx):
    span = ctx["span"]
    return 100.0 * (1.0 - span["busy_s"] / span["window_s"])
