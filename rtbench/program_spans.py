"""The program's own spans on the device trace's clock, and the device's
idle time split over them.

The program's recorder (``hermespy_rt_tpu_torch.utils.profiling``) records
its spans while a torch profiler records, on ``time.perf_counter_ns``; the
profiler's trace keeps its own clock.  The i-th root span ``hrt.api`` of
the recorder's latest session is matched with the i-th of the entry's own
API spans (:data:`API_SPANS`) by start, and every span of that call, its
backward included, is shifted by the API span's start less the root's.

The idle gaps are those :func:`rtbench.yardstick.idle_gaps` takes: the
complement of the device's busy intervals within the window.  Each instant
of a gap goes to the innermost program span the host was in (of the spans
covering it, the one that started last), and to that span's ancestors for
the time under a span at any depth.  Nothing is read where the program has
no recorder (a checkout older than it) or where the counts of calls differ.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from rtbench import yardstick

API_SPANS = ("api.trace", "api.compute_paths")
ROOT = "hrt.api"


def latest_session():
    """The program recorder's latest session, or None where the program
    has no recorder."""
    try:
        from hermespy_rt_tpu_torch.utils.profiling import latest_session
    except ImportError:
        return None
    return latest_session()


def anchored(trace: yardstick.Trace, session) -> Optional[list]:
    """The session's finished spans of the window's calls on the trace's
    clock: ``[(name, start_us, end_us, parent)]`` with ``parent`` an index
    into this list or None; None where the calls do not pair up."""
    if session is None:
        return None
    roots = sorted((sp for sp in session.finished() if sp.name == ROOT),
                   key=lambda sp: sp.start_ns)
    api = sorted(s for name, s, _ in trace.spans if name in API_SPANS)
    if not roots or len(roots) != len(api):
        return None
    shift = {r.call: a_us * 1e3 - r.start_ns for r, a_us in zip(roots, api)}
    out, index = [], {}
    for i, sp in enumerate(session.spans):
        if sp.end_ns is None or sp.call not in shift:
            continue
        index[i] = len(out)
        out.append((sp.name, (sp.start_ns + shift[sp.call]) / 1e3,
                    (sp.end_ns + shift[sp.call]) / 1e3, sp.parent))
    return [(name, s, e, index.get(p)) for name, s, e, p in out]


def split_idle(trace: yardstick.Trace, spans) -> Dict[str, Dict[str, float]]:
    """``{"innermost": {name: s}, "any_depth": {name: s}}``: the window's
    device idle by the innermost span the host was in, and by every span
    the host was in at any depth (each name counted once an instant)."""
    iv = yardstick.busy_intervals(trace.device)
    edges = np.array([trace.start_us] + [x for pair in iv for x in pair]
                     + [trace.end_us])
    a, b = edges[0::2], edges[1::2]
    keep = b > a
    a, b = a[keep], b[keep]
    # idle(t): the idle time between the window's start and t
    xp = np.stack([a, b], axis=1).reshape(-1)
    fp = np.concatenate([[0.0], np.cumsum(b - a)])
    fp = np.stack([fp[:-1], fp[1:]], axis=1).reshape(-1)
    idle = (lambda t: np.interp(t, xp, fp)) if len(xp) else (
        lambda t: np.zeros_like(t))
    inner: Dict[str, float] = {}
    depth: Dict[str, float] = {}
    if not spans:
        return dict(innermost=inner, any_depth=depth)
    cuts = np.unique([t for _, s, e, _ in spans for t in (s, e)])
    owner = np.full(len(cuts) - 1, -1)
    for k in sorted(range(len(spans)), key=lambda k: spans[k][1]):
        _, s, e, _ = spans[k]
        owner[np.searchsorted(cuts, s):np.searchsorted(cuts, e)] = k
    mine = owner >= 0
    per_span = np.bincount(owner[mine], weights=np.diff(idle(cuts))[mine],
                           minlength=len(spans)) / 1e6
    for k in np.flatnonzero(per_span):
        name = spans[k][0]
        inner[name] = inner.get(name, 0.0) + per_span[k]
        names, j = set(), k
        while j is not None:
            names.add(spans[j][0])
            j = spans[j][3]
        for name in names:
            depth[name] = depth.get(name, 0.0) + per_span[k]
    return dict(innermost=inner, any_depth=depth)


def idle_split(ctx) -> Optional[Dict[str, Dict[str, float]]]:
    """:func:`split_idle` of the traced window ``ctx.trace``, kept on
    ``ctx`` for the next reader; None where there is nothing to read."""
    if getattr(ctx, "trace", None) is None:
        return None
    if not hasattr(ctx, "program_idle"):
        spans = anchored(ctx.trace, latest_session())
        ctx.program_idle = (None if spans is None
                            else split_idle(ctx.trace, spans))
    return ctx.program_idle


def idle_ms(ctx, name: str) -> Optional[float]:
    """Device idle a call, in ms, while the host was under the program's
    span ``name`` at any depth."""
    split = idle_split(ctx)
    if split is None:
        return None
    return split["any_depth"].get(name, 0.0) * 1e3 / ctx.trace.calls
