"""The material-calibration step that ``hrt-torch-bench`` times.

The port's counterpart of the workload the JAX package's ``hrt-bench`` loads
from the repository's ``bench.py``: forward plus backward of the street
canyon's scatter gain power, ``(sum |a_te|^2 + sum |a_tm|^2) 1e9``, to the
material table; one TX at (-20, -10, 10), ``nrx`` RX at (10, 5, 2) + k (1.5,
-2, 0.25), 3 GHz, reference parity, compact and coherent rays.  A query is
one nearest-hit ray, ``B P (1 + nrx)`` a step.  :func:`measure` times the
step on the host clock as ``bench.py`` does: one warm-up step, then ``iters``
steps with one synchronisation after the warm-up and one after the loop, so
the host may run ahead of the device between steps.  Imports no JAX.
"""
from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from .api import trace
from .config import TracerConfig
from .materials import default_materials
from .scene import flatten_scene, load_hrt, random_soup_scene

__all__ = ["BENCH_FLAGS", "SHADE_BY_NRX", "CANYON", "TX", "FREQ_GHZ",
           "rx_positions", "bench_scene", "shade_for", "calibration_config",
           "calibration_step", "BenchStep", "measure"]

CANYON = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "simple_street_canyon_with_cars.hrt")

# bench.py's flags without the TPU-only precision, fuse4, gather and fetch_bwd
BENCH_FLAGS = dict(backend="auto", keep_rays=False, unroll_bounces=True,
                   compact_rays=True, launch_order="coherent",
                   grad_geometry=False)
# bench.py's shade for each nrx (chosen on a TPU): fused at nrx 1, else xla
SHADE_BY_NRX = {1: dict(shade="fused", grad_positions=False)}
XLA_SHADE = dict(shade="xla")

TX = ((-20.0, -10.0, 10.0),)
FREQ_GHZ = 3.0
_RX0, _RX_STEP = (10.0, 5.0, 2.0), (1.5, -2.0, 0.25)


def rx_positions(nrx):
    """``nrx`` RX positions, f32[nrx, 3]: (10, 5, 2) + k (1.5, -2, 0.25)."""
    k = np.arange(nrx, dtype=np.float32)[:, None]
    return (np.array([_RX0], np.float32)
            + k * np.array([_RX_STEP], np.float32))


def bench_scene(path=CANYON):
    """The street canyon read from ``path`` when it exists, else its stand-in
    ``random_soup_scene(234, seed=0, extent=90, tri_size=8)``."""
    if os.path.exists(path):
        return load_hrt(path)
    return random_soup_scene(234, seed=0, extent=90.0, tri_size=8.0)


def shade_for(nrx):
    """bench.py's shade at ``nrx`` receivers: ``"fused"`` or ``"xla"``."""
    return SHADE_BY_NRX.get(nrx, XLA_SHADE)["shade"]


def calibration_config(paths, bounces, fused, **kw):
    """:data:`BENCH_FLAGS` at ``paths`` and ``bounces``; with ``fused`` the
    fused path (``shade="fused", grad_positions=False``), else the op path
    (``shade="xla"``).  ``kw`` overrides any flag."""
    shade = SHADE_BY_NRX[1] if fused else XLA_SHADE
    with warnings.catch_warnings():   # coherent order under reference parity
        warnings.simplefilter("ignore")
        return TracerConfig(**{"num_paths": paths, "num_bounces": bounces,
                               **BENCH_FLAGS, **shade, **kw})


def _step(tris, rx, tx, freq_ghz, mats, cfg, backward):
    mats.zero_grad(set_to_none=True)
    with torch.set_grad_enabled(backward):
        res = trace(tris, rx, tx, carrier_frequency=freq_ghz, config=cfg,
                    materials=mats)
        loss = (res.scatter.a_te.abs().square().sum()
                + res.scatter.a_tm.abs().square().sum()) * 1e9
        if backward:
            loss.backward()
    return res, loss


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def calibration_step(tris, rx, tx, freq_ghz, mats, cfg, backward=True):
    """One step: trace, loss, backward to the material table ``mats``, on
    the device that holds the prepared scene ``tris``, then a
    synchronisation.  Returns ``(result, loss)``."""
    out = _step(tris, rx, tx, freq_ghz, mats, cfg, backward)
    _sync(tris.device)
    return out


class BenchStep:
    """The step :func:`measure` times, on ``device``: the bench scene
    flattened there, the default material table (its gradients are set
    anew by each step) and ``num_rx`` receivers; ``shade`` is ``"fused"``,
    ``"xla"`` or None for :func:`shade_for`.  Calling it runs one step
    without synchronising and returns ``(result, loss)``."""

    def __init__(self, num_paths=1 << 20, num_bounces=3, num_rx=1,
                 device="cuda", shade=None):
        self.shade = shade_for(num_rx) if shade is None else shade
        if self.shade not in ("fused", "xla"):
            raise ValueError(f"shade must be 'fused' or 'xla', not "
                             f"{self.shade!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "bench step on the CPU")
        self.cfg = calibration_config(num_paths, num_bounces,
                                      self.shade == "fused")
        self.tris = flatten_scene(bench_scene(), device=self.device)
        self.mats = default_materials(self.device)
        self.rx = rx_positions(num_rx)
        self.queries = num_bounces * len(TX) * num_paths * (1 + num_rx)

    def __call__(self):
        return _step(self.tris, self.rx, TX, FREQ_GHZ, self.mats, self.cfg,
                     True)


def measure(num_paths=1 << 20, num_bounces=3, num_rx=1, iters=8,
            device="cuda", shade=None):
    """``(queries_per_s, seconds_per_step, queries)`` of :class:`BenchStep`:
    one warm-up step, a synchronisation, ``iters`` steps, a synchronisation,
    on the host clock."""
    step = BenchStep(num_paths, num_bounces, num_rx, device, shade)
    step()
    _sync(step.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync(step.device)
    dt = (time.perf_counter() - t0) / iters
    return step.queries / dt, dt, step.queries
