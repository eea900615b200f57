"""``torch.cuda.max_memory_allocated()`` over the traced window (the peak
statistics reset before it), in GiB."""


def read(ctx):
    if ctx.trace is None or not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2 ** 30
