"""Nearest-hit queries the window completed, ``B P (1 + nrx)`` a call,
over the window's whole time (host clock; every call ends on the host)."""


def read(ctx):
    if not ctx.window_s:
        return None
    return ctx.queries / ctx.window_s
