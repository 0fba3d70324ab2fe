"""Host syncs a training step: the program's `sync` counts under its
`train.step` spans in the traced span without stacks, per step."""

from benchmark.reference import spans


def read(ctx):
    span = ctx["span"]
    sel = spans.select(spans.program_records(), span, "train.step",
                       span["steps"])
    return None if sel is None else spans.syncs_per_root(sel)
