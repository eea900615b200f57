"""The row gather's share of its roofline, in %: the least time of a
call's gathers on an H100 SXM at 700 W (the rows they write, the
program's ``fetch.values`` a call times 4 bytes, over 3.35 TB/s;
:mod:`rtbench.gather_work`) over the device time of ``gather_kernel`` a
call.  Nothing where the program counts no fetched values (a checkout
older than the counter) or the calls run no gather."""
from rtbench import gather_work, yardstick


def read(ctx):
    if ctx.trace is None or not ctx.work or "fetch_values" not in ctx.work:
        return None
    s = gather_work.kernel_s(ctx.trace) / ctx.trace.calls
    if s <= 0:
        return None
    n_bytes = gather_work.written_bytes(ctx.work["fetch_values"])
    return yardstick.bound(n_bytes, 0)[0] / s * 100.0
