"""The share, in %, of the device's idle time in the traced span without
stacks (the gaps between its device operations) that lies in gaps
beginning while the host waits in one of the program's `sync.*` spans,
the spans taken onto the trace's clock."""

from benchmark.reference import spans


def read(ctx):
    span = ctx["span"]
    sel = spans.select(spans.program_records(), span, "train.step",
                       span["steps"])
    return None if sel is None else spans.sync_idle_share(sel, span["items"])
