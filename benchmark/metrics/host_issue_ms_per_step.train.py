"""Host ms a training step spends outside its waits on the device: the
mean of the program's `train.step` spans in the traced span without
stacks (its grid update included) less the time in the `sync.*` spans
under them."""

from benchmark.reference import spans


def read(ctx):
    span = ctx["span"]
    sel = spans.select(spans.program_records(), span, "train.step",
                       span["steps"])
    return None if sel is None else spans.host_issue_ms(sel)
