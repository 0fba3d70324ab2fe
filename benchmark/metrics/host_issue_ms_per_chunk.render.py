"""Host ms a test chunk spends outside its waits on the device: the mean
of the program's `test.chunk` spans in the traced view (without stacks)
less the time in the `sync.*` spans under them."""

from benchmark.reference import spans


def read(ctx):
    span = ctx["span"]
    sel = spans.select(spans.program_records(), span, "test.chunk",
                       span["chunks"])
    return None if sel is None else spans.host_issue_ms(sel)
