"""Coverage maps: received power over a grid of RX probes.

The counterpart of :mod:`hermespy_rt_tpu.models.coverage`: one TX traced
against a rectangular probe grid in batches of ``batch_size`` RX (the last
batch zero-padded, so every batch has one shape), reduced per cell to path
gain, RMS delay spread and the LoS pass's occlusion decision.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import TracerConfig
from ..materials import MaterialTable

__all__ = ["CoverageGrid", "coverage_map"]


@dataclasses.dataclass(frozen=True)
class CoverageGrid:
    """A rectangular RX probe grid and its per-cell results."""

    x: np.ndarray            # f32[NX]
    y: np.ndarray            # f32[NY]
    height: float
    gain_db: np.ndarray      # f32[NY, NX]  total received power, dB
    rms_delay: np.ndarray    # f32[NY, NX]  seconds
    los_blocked: np.ndarray  # bool[NY, NX]


def coverage_map(scene, tx_position,
                 x_range: Tuple[float, float], y_range: Tuple[float, float],
                 resolution: float = 1.0, height: float = 1.5,
                 carrier_frequency_ghz: float = 3.0,
                 config: Optional[TracerConfig] = None,
                 materials: Optional[MaterialTable] = None,
                 batch_size: int = 256, device="cuda") -> CoverageGrid:
    """Trace a TX against a grid of RX probes at ``height`` and reduce it to
    per-cell total path gain (dB), RMS delay spread and LoS blockage, as
    numpy arrays.  Runs on ``device`` (a prepared TriangleSoA on the device
    that holds it); no gradient is kept."""
    from ..api import prepare_scene, trace
    from .channel import path_gain_db, rms_delay_spread

    cfg = config or TracerConfig(num_paths=4096, num_bounces=3,
                                 keep_rays=False)
    xs = np.arange(x_range[0], x_range[1] + 1e-9, resolution,
                   dtype=np.float32)
    ys = np.arange(y_range[0], y_range[1] + 1e-9, resolution,
                   dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    probes = np.stack([gx.ravel(), gy.ravel(),
                       np.full(gx.size, height, np.float32)], axis=-1)
    tx = np.asarray(tx_position, np.float32).reshape(-1, 3)

    tris = prepare_scene(scene, device=device)
    n = probes.shape[0]
    gains = np.empty(n, np.float32)
    delays = np.empty(n, np.float32)
    blocked = np.empty(n, bool)
    with torch.no_grad():
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            chunk = probes[lo:hi]
            pad = batch_size - (hi - lo)
            if pad:
                chunk = np.concatenate([chunk,
                                        np.zeros((pad, 3), np.float32)])
            res = trace(tris, chunk, tx, None, None, carrier_frequency_ghz,
                        config=cfg, materials=materials)
            k = hi - lo
            gains[lo:hi] = path_gain_db(res)[:k, 0].cpu().numpy()
            delays[lo:hi] = rms_delay_spread(res)[:k, 0].cpu().numpy()
            # the tracer's occlusion decision, not |a_te| == 0: under
            # transmission a blocked LoS keeps a penetration-loss gain
            blocked[lo:hi] = res.los_blocked[:k, 0].cpu().numpy()

    shape = (ys.size, xs.size)
    return CoverageGrid(x=xs, y=ys, height=height,
                        gain_db=gains.reshape(shape),
                        rms_delay=delays.reshape(shape),
                        los_blocked=blocked.reshape(shape))
