"""Device ms per step of compositing (ops/compositing.py), forward and
backward; from the traced span with stacks."""


def read(ctx):
    span = ctx["span_stack"]
    us = sum(dur for _, _, dur, frames, _ in span["items"]
             if any("ops/compositing.py" in f for f in frames))
    return us / 1e3 / span["steps"]
