"""``1 - busy / wall`` over the traced window of whole calls: the share of
the window in which no operation ran on the device."""
from rtbench import yardstick


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 1.0 - yardstick.busy_s(ctx.trace) / ctx.trace.wall_s
