"""The 95th percentile of the latency of every call in the window, from
the call to its result on the host (host clock), in ms."""
import numpy as np


def read(ctx):
    if not ctx.latencies:
        return None
    return float(np.percentile(np.asarray(ctx.latencies), 95)) * 1e3
