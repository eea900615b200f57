"""Device time a call of the visit-list walk (``walk_prepass_kernel``,
``walk_kernel``), in ms; nothing where no call walks."""
from rtbench import yardstick

KERNELS = ("walk_kernel", "walk_prepass_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    s = yardstick.kernel_s(ctx.trace, KERNELS)
    return s * 1e3 / ctx.trace.calls if s > 0 else None
