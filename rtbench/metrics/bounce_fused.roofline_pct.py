"""The fused bounce kernels' share of their roofline, in %: the least time
of a call's bounce shading on an H100 SXM at 700 W (the larger of its
bytes over 3.35 TB/s and its f32 operations over 67 TFLOP/s,
``yardstick.bounce_shading_work``: the shading's own inputs and outputs,
each once, never the intermediates between the two kernels) over the
device time of ``bounce_pre_kernel`` and ``bounce_post_kernel`` a call.
Nothing where the calls run no such kernel or the live rays are not
known."""
from rtbench import yardstick

KERNELS = ("bounce_pre_kernel", "bounce_post_kernel")


def read(ctx):
    if ctx.trace is None or ctx.work is None:
        return None
    s = yardstick.kernel_s(ctx.trace, KERNELS) / ctx.trace.calls
    if s <= 0:
        return None
    n_bytes, n_ops = yardstick.bounce_shading_work(
        ctx.work["rays"], ctx.work["nrx"], ctx.work["live"])
    return yardstick.bound(n_bytes, n_ops)[0] / s * 100.0
