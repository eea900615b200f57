"""Timing, profiling and metric records of traces.

The counterpart of :mod:`hermespy_rt_tpu.utils.profiling`: a wall-clock
harness reporting intersection queries a second (``num_bounces · num_tx ·
num_paths · (1 + num_rx)`` a trace, one nearest-hit ray per LoS-free
bounce query and per shadow ray), one structured metrics record a run, and
a ``torch.profiler`` context that writes a Chrome trace.  Device time of a
call is :func:`hermespy_rt_tpu_torch.measure.profiled`'s window.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import asdict, dataclass
from typing import Callable, Optional

import numpy as np
import torch

logger = logging.getLogger("hermespy_rt_tpu_torch")

__all__ = ["TraceStats", "time_trace", "profile_trace", "log_metrics",
           "device_to_numpy"]


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
    """A ``torch.profiler`` window over the body (the host, and the card
    where there is one), written on exit as a Chrome trace
    (``chrome://tracing``, Perfetto) into ``log_dir``.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
