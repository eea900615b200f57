"""Device operations (kernels, copies, sets) a call in the traced
window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.trace.calls
