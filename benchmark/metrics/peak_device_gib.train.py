"""Peak device memory allocated by the run (torch.cuda.max_memory_
allocated), in GiB."""


def read(ctx):
    return ctx["memory_peak_bytes"] / 2 ** 30
