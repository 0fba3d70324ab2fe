"""The share, in %, of the device's idle time in the traced view (without
stacks) that lies in gaps beginning while the host waits in one of the
program's `sync.*` spans, the spans taken onto the trace's clock."""

from benchmark.reference import spans


def read(ctx):
    span = ctx["span"]
    sel = spans.select(spans.program_records(), span, "test.chunk",
                       span["chunks"])
    return None if sel is None else spans.sync_idle_share(sel, span["items"])
