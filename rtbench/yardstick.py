"""The benchmark's yardstick: the H100's peaks, the bound rule, the fused
bounce kernels' work, and the profiler window with its reduction to busy
time, idle gaps and device operations.

The peaks, the operation counts of the fused stages, ``bound`` and the
window's warm-up cycle are a frozen copy of ``hermespy_rt_tpu_torch/
measure.py`` at commit 4304014e, so that a change to the program cannot
move them.  Imports nothing of the program.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): device memory rate
# and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations of the fused bounce stages (measure.py, counted in
# csrc/bounce_fused.cu): the pre stage per live ray plus per (live ray, RX),
# the post stage per (live ray, RX)
PRE_OPS_PER_RAY, PRE_OPS_PER_RX = 180, 30
POST_OPS_PER_RX = 150

# bytes of one ray's state: origin and direction (f32[3] each), the six
# state rows (TE and TM gains re/im, delay, Doppler), an activity byte and
# the hit triangle's id
RAY_STATE_BYTES = 12 + 12 + 24 + 1 + 4
PAYLOAD_ROW_BYTES = 27 * 4   # v0, e1, e2, normal, velocity, 12 eta columns
SHADOW_HIT_BYTES = 4 + 4     # a shadow ray's t and blocker id
PATH_ROW_BYTES = 6 * 4 + 1 + 12   # gains, delay, Doppler, write, direction


def bound(n_bytes: float, n_ops: float):
    """(least time in s on an H100 SXM, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bounce_shading_work(rays: int, nrx: int, live: List[int]):
    """(bytes, f32 operations) of one call's bounce shading, the work of
    the fused pre and post kernels whatever implements it: per bounce every
    ray's state and hit id in and its next state out, each live ray's
    payload row (geometry and material eta row) and its shadow answers in,
    and every (ray, RX) path row out (gains, delay, Doppler, write flag,
    direction).  The intermediates the two stages pass between them are
    not counted.  ``live``: the live rays of each bounce."""
    n_bytes = n_ops = 0
    for n_live in live:
        n_bytes += (2 * rays * RAY_STATE_BYTES
                    + n_live * (PAYLOAD_ROW_BYTES + nrx * SHADOW_HIT_BYTES)
                    + rays * nrx * PATH_ROW_BYTES)
        n_ops += n_live * (PRE_OPS_PER_RAY + nrx * (PRE_OPS_PER_RX
                                                     + POST_OPS_PER_RX))
    return n_bytes, n_ops


class Trace(NamedTuple):
    """One profiled window of whole calls."""

    calls: int
    wall_s: float                 # host clock over the recorded calls
    device: list                  # [(name, start_us, end_us)]
    spans: list                   # [(name, start_us, end_us)] of our spans
    start_us: float               # the window on the trace's clock
    end_us: float
    missed: int                   # launches the window did not record
    tries: int


TRIES = 3   # windows a measurement may take while they miss launches


def profiled(fn: Callable[[int], object], calls: int, span_names,
             launches: Optional[Callable[[], Dict[str, int]]] = None
             ) -> Trace:
    """``calls`` calls of ``fn(i)`` in one torch.profiler window, opened on
    a warm-up cycle of as many calls in which the profiler traces the device
    and drops the events (a window opened cold can miss its first
    launches), as ``measure.profiled`` does.  ``missed`` counts, per kernel
    wrapper named by ``launches`` (name to launch count), the launches the
    recorded cycle made beyond its device rows ``<name>_kernel``.  A window
    that missed any is taken again, up to :data:`TRIES` windows."""
    for n in range(1, TRIES + 1):
        w = _window(fn, calls, span_names, launches)._replace(tries=n)
        if not w.missed:
            break
    return w


def _window(fn, calls, span_names, launches):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else []),
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for i in range(calls):
            fn(i)
        sync()
        prof.step()
        before = launches() if launches else {}
        t0 = time.perf_counter()
        for i in range(calls, 2 * calls):
            fn(i)
        sync()
        wall_s = time.perf_counter() - t0
        after = launches() if launches else {}
    device, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name in span_names:
            # a span is recorded on the host and, as an annotation over the
            # device work it launched, on the device: only the first is one
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name, tr.start, tr.end))
        elif (e.device_type == DeviceType.CUDA
              and not e.name.startswith("ProfilerStep")):
            device.append((e.name, tr.start, tr.end))
    start = min((s for _, s, _ in spans), default=0.0)
    end = max([e for _, _, e in spans] + [e for _, _, e in device],
              default=start)
    missed = 0
    for name, n in after.items():
        recorded = sum(1 for k, _, _ in device if f"{name}_kernel" in k)
        missed += max(0, n - before.get(name, 0) - recorded)
    if not device:
        missed = max(missed, 1)
    return Trace(calls, wall_s, device, spans, start, end, missed, 1)


def busy_intervals(device) -> np.ndarray:
    """The union of the device events' intervals, [n, 2] in us, sorted."""
    if not device:
        return np.zeros((0, 2))
    iv = np.array(sorted((s, e) for _, s, e in device), dtype=np.float64)
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def busy_s(trace: Trace) -> float:
    iv = busy_intervals(trace.device)
    return float((iv[:, 1] - iv[:, 0]).sum()) / 1e6


def device_ops(trace: Trace, top: int = 10):
    """[[name, seconds], ...]: the device operations that took most time in
    the window, summed by name."""
    by = {}
    for name, s, e in trace.device:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]


def kernel_s(trace: Trace, names) -> float:
    """Device seconds of the events whose name holds one of ``names``."""
    return sum(e - s for k, s, e in trace.device
               if any(n in k for n in names)) / 1e6


def idle_gaps(trace: Trace, top: int = 10):
    """[[host span, seconds], ...]: the device's idle time in the window
    (between its busy intervals, and before the first and after the last)
    by the benchmark's span the host was in; time in none of them is
    ``between_calls``."""
    iv = busy_intervals(trace.device)
    edges = [trace.start_us] + [x for pair in iv for x in pair] \
        + [trace.end_us]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    spans = sorted(trace.spans, key=lambda x: x[1])
    starts = np.array([s for _, s, _ in spans])
    by = {}
    for a, b in gaps:
        covered = 0.0
        i = max(int(np.searchsorted(starts, a, side="right")) - 1, 0)
        while i < len(spans) and spans[i][1] < b:
            name, s, e = spans[i]
            ov = min(b, e) - max(a, s)
            if ov > 0:
                by[name] = by.get(name, 0.0) + ov / 1e6
                covered += ov
            i += 1
        rest = (b - a) - covered
        if rest > 0:
            by["between_calls"] = by.get("between_calls", 0.0) + rest / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]
