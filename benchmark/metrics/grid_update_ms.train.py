"""Device ms per density-grid update (Trainer.update_grid), from the
traced span with stacks: the device time launched under update_grid over
the updates in the span."""

from benchmark.reference import trace


def read(ctx):
    span = ctx["span_stack"]
    if not span["updates"]:
        return None
    return 1e3 * trace.under(span["items"], "update_grid") / span["updates"]
