"""Device time a call of the brute nearest-hit kernels (``nearest_hit_
kernel``, ``nearest_hit_culled_kernel``), in ms; nothing where no call
scans."""
from rtbench import yardstick

KERNELS = ("nearest_hit_kernel", "nearest_hit_culled_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    s = yardstick.kernel_s(ctx.trace, KERNELS)
    return s * 1e3 / ctx.trace.calls if s > 0 else None
