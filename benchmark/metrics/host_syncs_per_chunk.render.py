"""Host syncs a test chunk: the program's `sync` counts under its
`test.chunk` spans in the traced view (without stacks), per chunk."""

from benchmark.reference import spans


def read(ctx):
    span = ctx["span"]
    sel = spans.select(spans.program_records(), span, "test.chunk",
                       span["chunks"])
    return None if sel is None else spans.syncs_per_root(sel)
