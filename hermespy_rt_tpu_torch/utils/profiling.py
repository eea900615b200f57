"""Timing, profiling and metric records of traces, and the program's own
spans and counters.

The counterpart of :mod:`hermespy_rt_tpu.utils.profiling`: a wall-clock
harness reporting intersection queries a second (``num_bounces · num_tx ·
num_paths · (1 + num_rx)`` a trace, one nearest-hit ray per LoS-free
bounce query and per shadow ray), one structured metrics record a run, and
:func:`profile_trace`, a ``torch.profiler`` window written as a Chrome
trace with the program's spans in it.  Device time of a call is
:func:`hermespy_rt_tpu_torch.measure.profiled`'s window.

**The recorder.**  The API and the tracer open named spans
(:func:`span`, :func:`api_call`, :func:`traced_backward`) and count into one
registry (:data:`COUNTERS`: every kernel wrapper's launches,
:class:`LaunchCounter`; the collectives of ``parallel.sharding``).  Spans are
recorded while an operator has called :func:`enable` or while a torch
profiler records (``torch.autograd._profiler_enabled()``); otherwise a span
is one boolean check and nothing else.  Either way the recorder launches no
device operation, synchronises nothing and emits no profiler annotation:
only :func:`profile_trace` turns its spans into ``record_function`` ranges,
inside its own window.  Each time recording turns on after being off a new
:class:`Session` starts; :func:`latest_session` reads the newest.  A span
holds its name, the call it belongs to (every span of one API call shares
its ``call``, the backward's included), its parent, its thread, its start
and end on ``time.perf_counter_ns`` and the kernel launches made inside it.
The spans and what reads them are listed in the README.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import threading
import time
from collections.abc import MutableMapping
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger("hermespy_rt_tpu_torch")

__all__ = ["TraceStats", "time_trace", "profile_trace", "log_metrics",
           "device_to_numpy", "COUNTERS", "count", "LaunchCounter",
           "CounterView", "span", "open_span", "call_span", "api_call",
           "current_call", "traced_backward", "enable", "disable",
           "recording", "Span", "Session", "latest_session", "ROOT"]

# --- the recorder -----------------------------------------------------------

COUNTERS: Dict[str, float] = {"launches": 0}
"""Every counter of the program by name, counted whether or not spans are
recorded: ``launches`` (all kernel launches), ``launches.<kernel>`` (one
wrapper's, :class:`LaunchCounter`), ``collective.calls`` / ``.bytes`` /
``.seconds`` (``parallel.sharding.COLLECTIVES``), ``queries`` (every
nearest-hit query of a scene access), ``queries.masked`` (those given the
rays' activity mask), ``trace.fused`` / ``trace.op`` (the bounce loops
run through the fused kernels / through the op path), ``fetch.rows`` /
``fetch.values`` (the rows and the values the row gather fetched) and
``transmit.blocker_rows`` (the blocker rows fetched under
``transmission``)."""

ROOT = "hrt.api"          # the span of one API call
BACKWARD = "hrt.backward"
MAX_SPANS = 1 << 18       # spans a session keeps; later ones are counted

_profiler_enabled = torch.autograd._profiler_enabled
_operator = False         # enable() / disable()
_live: Optional["Session"] = None     # the session recording, None when off
_latest: Optional["Session"] = None
_sessions = itertools.count(1)
_calls = itertools.count(1)
_tls = threading.local()
_annotate = None          # set by profile_trace: record_function


def count(name: str, n=1):
    """Add ``n`` to the counter ``name``."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n


class LaunchCounter:
    """A kernel wrapper's launch count, kept in :data:`COUNTERS` as
    ``launches.<kernel>``; ``launches`` reads and assigns it, and every
    launch also adds to ``launches``, which the spans read."""

    def __init__(self, kernel: str):
        self._counter = "launches." + kernel
        COUNTERS.setdefault(self._counter, 0)

    @property
    def launches(self) -> int:
        return COUNTERS[self._counter]

    @launches.setter
    def launches(self, n: int):
        COUNTERS[self._counter] = n

    def launched(self, n: int = 1):
        COUNTERS[self._counter] += n
        COUNTERS["launches"] += n


class CounterView(MutableMapping):
    """The counters ``<prefix>.<key>`` of :data:`COUNTERS` as a mapping
    keyed by ``key``: reads, assignments and ``update`` go to the registry,
    and ``dict(view)`` copies their values."""

    def __init__(self, prefix: str, **initial):
        self._prefix = prefix + "."
        self._keys = list(initial)
        for k, v in initial.items():
            COUNTERS.setdefault(self._prefix + k, v)

    def __getitem__(self, key):
        return COUNTERS[self._prefix + key]

    def __setitem__(self, key, value):
        if key not in self._keys:
            self._keys.append(key)
        COUNTERS[self._prefix + key] = value

    def __delitem__(self, key):
        raise TypeError("a counter cannot be removed")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __repr__(self):
        return repr(dict(self))


class Session:
    """One stretch of recording: the spans opened from the moment recording
    turned on after being off, in the order they opened, and the growth of
    each counter over the session's finished top-level spans."""

    def __init__(self, index: int):
        self.index = index
        self.spans: List["Span"] = []
        self.dropped = 0             # spans past MAX_SPANS, not kept
        self._c0 = dict(COUNTERS)
        self._c1 = self._c0

    @property
    def counters(self) -> Dict[str, float]:
        return {k: v - self._c0.get(k, 0) for k, v in self._c1.items()
                if v != self._c0.get(k, 0)}

    def finished(self) -> List["Span"]:
        return [s for s in self.spans if s.end_ns is not None]


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


class Span:
    """One span, the record and its context manager.  ``parent`` is the
    index in the session of the span open around it on its thread (None at
    the top), ``launches`` the kernel launches counted between its start
    and end, on any thread."""

    __slots__ = ("name", "call", "parent", "thread", "start_ns", "end_ns",
                 "launches", "attrs", "_session", "_index", "_l0", "_rf")

    def __init__(self, name: str, attrs: Optional[dict] = None, call=None):
        self.name, self.attrs, self.call = name, attrs, call
        self.parent = self.end_ns = self.launches = self._rf = None
        self._session = None

    def __enter__(self):
        global _live, _latest
        s = _live
        if s is None:
            s = _live = _latest = Session(next(_sessions))
        if len(s.spans) >= MAX_SPANS:
            s.dropped += 1
            return self
        stack = _stack()
        if stack and stack[-1]._session is not s:
            stack.clear()
        if stack:
            top = stack[-1]
            self.parent = top._index
            if self.call is None:
                self.call = top.call
        self._session, self._index = s, len(s.spans)
        self.thread = threading.get_ident()
        s.spans.append(self)
        stack.append(self)
        if _annotate is not None:
            self._rf = _annotate(self.name)
            self._rf.__enter__()
        self._l0 = COUNTERS["launches"]
        self.start_ns = time.perf_counter_ns()
        return self

    def close(self, *exc):
        s = self._session
        if s is None or self.end_ns is not None:
            return
        self.end_ns = time.perf_counter_ns()
        self.launches = COUNTERS["launches"] - self._l0
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            del stack[stack.index(self):]   # and any left open inside it
        if self.parent is None:
            s._c1 = dict(COUNTERS)

    __exit__ = close


class _Off:
    """The span handed out while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def close(self, *exc):
        pass

    __exit__ = close


_OFF = _Off()


def recording() -> bool:
    """Whether spans are recorded now: an operator enabled the recorder, or
    a torch profiler records."""
    return _operator or _profiler_enabled()


def span(name: str, **attrs):
    """A span ``name`` (with ``attrs``) around the body of a ``with``, a
    child of the span open on this thread; a no-op while nothing records."""
    if _operator or _profiler_enabled():
        return Span(name, attrs or None)
    global _live
    _live = None      # off: the next span recorded starts a new session
    return _OFF


def open_span(name: str, **attrs):
    """:func:`span` opened at once; ``close()`` ends it."""
    return span(name, **attrs).__enter__()


def call_span():
    """The root span :data:`ROOT` of one API call, with a new call id, or a
    no-op inside another call on this thread: only the outermost call
    opens one."""
    if not (_operator or _profiler_enabled()):
        global _live
        _live = None
        return _OFF
    if any(s.name == ROOT for s in _stack()):
        return _OFF
    return Span(ROOT, call=next(_calls))


def api_call(fn):
    """``fn`` run inside :func:`call_span`: an API entry point."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with call_span():
            return fn(*args, **kwargs)
    return call


def current_call():
    """``(session, call)`` of the span open on this thread, or None: what
    an autograd Function keeps in its ``ctx`` for :func:`traced_backward`."""
    if _live is None:
        return None
    stack = _stack()
    if not stack or stack[-1]._session is not _live:
        return None
    return _live, stack[-1].call


def traced_backward(fn):
    """An autograd Function's ``backward`` inside the span :data:`BACKWARD`
    of the call its forward ran in, ``ctx.call`` (:func:`current_call` of
    the forward): recorded when the forward was, in the same session, on
    whatever thread autograd runs it."""
    @functools.wraps(fn)
    def backward(ctx, *grads):
        carried = getattr(ctx, "call", None)
        if carried is None or carried[0] is not _live:
            return fn(ctx, *grads)
        with Span(BACKWARD, call=carried[1]):
            return fn(ctx, *grads)
    return backward


def enable():
    """Record spans until :func:`disable`, profiler or not; a new session
    starts unless recording was on already."""
    global _operator, _live
    if not recording():
        _live = None
    _operator = True


def disable():
    global _operator
    _operator = False


def latest_session() -> Optional[Session]:
    """The newest session, or None before any span was recorded."""
    return _latest


# --- timing and traces ------------------------------------------------------


def device_to_numpy(x):
    """A tensor (on any device, with or without a graph) as a numpy array;
    anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class TraceStats:
    wall_s: float
    queries: int
    queries_per_s: float
    num_paths: int
    num_bounces: int
    num_rx: int
    num_tx: int
    iters: int

    def json(self) -> str:
        return json.dumps(asdict(self))


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_trace(fn: Callable, *args, num_paths: int, num_bounces: int,
               num_rx: int = 1, num_tx: int = 1, iters: int = 5,
               warmup: int = 1) -> TraceStats:
    """Mean wall time of ``fn(*args)`` over ``iters`` calls after
    ``warmup``, each run ending in ``torch.cuda.synchronize()`` on a card,
    and the queries a second it gives."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    wall = (time.perf_counter() - t0) / iters
    queries = num_bounces * num_tx * num_paths * (1 + num_rx)
    return TraceStats(wall_s=wall, queries=queries,
                      queries_per_s=queries / wall, num_paths=num_paths,
                      num_bounces=num_bounces, num_rx=num_rx, num_tx=num_tx,
                      iters=iters)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """The operator's exporter: a ``torch.profiler`` window over the body
    (the host, and the card where there is one) with the recorder on,
    written on exit as a Chrome trace (``chrome://tracing``, Perfetto)
    into ``log_dir``.  Inside this window alone each span is also a
    ``record_function`` range, so it sits over the device work it launched
    on the trace's device rows; the written ranges carry the span's
    ``launches``, ``call`` and attributes as arguments.  Yields the
    profiler; its ``trace_path`` is the file once the window has closed."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    global _annotate, _live
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    was_on = _operator
    with profile(activities=acts) as prof:
        _live = None                 # the window's spans: a session of its own
        enable()
        _annotate = record_function
        try:
            yield prof
            _sync()
        finally:
            _annotate = None
            if not was_on:
                disable()
    session = _latest
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
    if session is not None:
        _span_args(prof.trace_path, session)


def _span_args(path: str, session: Session):
    """Give each span's ``record_function`` range in the Chrome trace at
    ``path`` the span's launches, call and attributes as arguments: the
    ranges of a name are matched to its spans in the order they opened."""
    with open(path) as fh:
        trace = json.load(fh)
    spans: Dict[str, list] = {}
    for sp in session.finished():
        spans.setdefault(sp.name, []).append(sp)
    ranges: Dict[str, list] = {}
    for e in trace.get("traceEvents", []):
        if e.get("cat") == "user_annotation" and e.get("name") in spans:
            ranges.setdefault(e["name"], []).append(e)
    for name, evs in ranges.items():
        if len(evs) != len(spans[name]):
            logger.warning("profile_trace: %d ranges of %s for %d spans; "
                           "their arguments are left out", len(evs), name,
                           len(spans[name]))
            continue
        for e, sp in zip(sorted(evs, key=lambda e: e["ts"]), spans[name]):
            e.setdefault("args", {}).update(launches=sp.launches,
                                            call=sp.call, **(sp.attrs or {}))
    with open(path, "w") as fh:
        json.dump(trace, fh)


def log_metrics(stats: TraceStats, extra: Optional[dict] = None,
                path: Optional[str] = None):
    """Emit one structured metrics line (the package logger, and appended
    to the JSONL file ``path`` when given); returns the record."""
    record = asdict(stats)
    if extra:
        record.update(extra)
    line = json.dumps(record)
    logger.info("metrics %s", line)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")
    return record
