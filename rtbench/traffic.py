"""The one traffic generator: receiver positions, calibration targets and
the check's samples, from a cell's ``traffic`` parameters and the run's
seed.  Every stream has its own ``numpy`` generator keyed by ``(seed,
stream)``, so the same seed gives the same inputs and one stream never
shifts another.

``rx`` parameters (one kind per cell):

* ``{"kind": "line", "base": [x, y, z], "step": [dx, dy, dz], "count": n,
  "jitter": j}``: ``base + k step`` plus a uniform jitter in ``[-j, j]``
  on x and y;
* ``{"kind": "box", "lo": [x, y, z], "hi": [x, y, z], "count": n,
  "avoid_footprints": bool, "margin": m}``: uniform in the box, optionally
  outside every building footprint grown by ``margin``.

``per_call`` true draws new positions for each call (a pool of ``pool``
drops, cycled); false draws them once (the measurement points of a
calibration).  ``rx_seed`` draws the positions from that seed instead of
the run's, so that every run has the same points (and the same work); the
run's seed then only orders them.
"""
from __future__ import annotations

import numpy as np

STREAMS = ("rx", "warmup", "targets", "paths", "check_calls")


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63),
                                  STREAMS.index(stream)])


def draw_rx(params: dict, n_sets: int, gen: np.random.Generator,
            footprints: np.ndarray) -> np.ndarray:
    """``n_sets`` RX sets, f32[n_sets, count, 3]."""
    n = int(params["count"])
    if params["kind"] == "line":
        k = np.arange(n)[None, :, None]
        pos = (np.asarray(params["base"])[None, None]
               + k * np.asarray(params["step"])[None, None])
        jit = gen.uniform(-params["jitter"], params["jitter"],
                          size=(n_sets, n, 2))
        pos = np.repeat(pos, n_sets, axis=0)
        pos[..., :2] += jit
        return pos.astype(np.float32)
    if params["kind"] != "box":
        raise ValueError(f"unknown rx kind {params['kind']!r}")
    lo, hi = np.asarray(params["lo"], float), np.asarray(params["hi"], float)
    want = n_sets * n
    out = np.zeros((0, 3))
    while len(out) < want:
        p = gen.uniform(lo, hi, size=(2 * want, 3))
        if params.get("avoid_footprints") and len(footprints):
            m = float(params.get("margin", 0.0))
            f = footprints
            inside = ((p[:, None, 0] >= f[None, :, 0] - m)
                      & (p[:, None, 0] <= f[None, :, 2] + m)
                      & (p[:, None, 1] >= f[None, :, 1] - m)
                      & (p[:, None, 1] <= f[None, :, 3] + m)).any(axis=1)
            p = p[~inside]
        out = np.concatenate([out, p])
    return out[:want].reshape(n_sets, n, 3).astype(np.float32)


def make(traffic: dict, seed: int, footprints: np.ndarray) -> dict:
    """The inputs of one run: ``rx`` f32[pool, count, 3] (one set when
    drawn once), ``warmup`` RX sets for the set-up's calls, and with a
    ``targets_db`` range the calibration targets f32[count]."""
    per_call = bool(traffic.get("per_call", False))
    pool = int(traffic.get("pool", 4096)) if per_call else 1
    fixed = traffic.get("rx_seed")
    rx = draw_rx(traffic["rx"], pool, rng(seed if fixed is None else fixed,
                                          "rx"), footprints)
    if fixed is not None:
        order = rng(seed, "rx").permutation(rx.shape[1])
        rx = rx[:, order]
    out = dict(
        rx=rx,
        warmup=draw_rx(traffic["rx"], int(traffic.get("warmup_calls", 2)),
                       rng(seed, "warmup"), footprints),
        per_call=per_call)
    if "targets_db" in traffic:
        lo, hi = traffic["targets_db"]
        out["targets_db"] = rng(seed, "targets").uniform(
            lo, hi, size=int(traffic["rx"]["count"])).astype(np.float32)
    return out
