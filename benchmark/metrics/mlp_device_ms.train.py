"""Device ms per step of the MLPs (models/mlp.py::apply_mlp), forward
and backward, grid updates left out; from the traced span with stacks."""


def read(ctx):
    span = ctx["span_stack"]
    us = sum(dur for _, _, dur, frames, _ in span["items"]
             if any("models/mlp.py" in f for f in frames)
             and not any("update_grid" in f for f in frames))
    return us / 1e3 / span["steps"]
