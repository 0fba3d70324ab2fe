"""Host-synced march iterations per chunk of the validation render over
the window: a count (one host read of the loop's condition each)."""


def read(ctx):
    w = ctx["window"]
    return w["iterations"] / w["chunks"]
