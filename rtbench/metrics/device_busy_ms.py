"""Device busy time a call in the traced window, in ms: the union of the
device operations' intervals."""
from rtbench import yardstick


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return yardstick.busy_s(ctx.trace) * 1e3 / ctx.trace.calls
