"""Batched sweeps with per-chunk checkpoint and resume.

The counterpart of :mod:`hermespy_rt_tpu.models.sweep`, in the same file
format: the RX set is cut into chunks, each chunk traced (the last one
zero-padded to the chunk size) and written as one ``chunk_NNNNN.npz`` with
the keys ``rx_positions, a_te, a_tm, tau, freq_shift, los_a_te, los_tau``,
beside a ``manifest.json``.  A rerun skips every chunk whose file exists and
holds its RX count, so either package resumes the other's sweep and reads
its results.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import TracerConfig
from ..materials import MaterialTable, default_materials

__all__ = ["SweepConfig", "run_sweep", "load_sweep_results"]


@dataclass(frozen=True)
class SweepConfig:
    """A chunked sweep over RX positions for a fixed TX set."""

    output_dir: str
    chunk_size: int = 64
    carrier_frequency_ghz: float = 3.0
    tracer: TracerConfig = field(default_factory=lambda: TracerConfig(
        num_paths=4096, num_bounces=3, keep_rays=False))


def _chunk_path(out_dir: str, idx: int) -> str:
    return os.path.join(out_dir, f"chunk_{idx:05d}.npz")


def _chunk_valid(path: str, expect_rx: int) -> bool:
    if not os.path.exists(path):
        return False
    try:
        with np.load(path) as z:
            return z["a_te"].shape[0] == expect_rx
    except Exception:
        return False


def _host(x, k):
    return x[:k].cpu().numpy()


def run_sweep(scene, tx_positions, rx_positions, cfg: SweepConfig,
              materials: Optional[MaterialTable] = None,
              tx_velocities=None, rx_velocities=None,
              progress: bool = False, device="cuda") -> int:
    """Trace ``rx_positions`` against ``tx_positions`` in resumable chunks on
    ``device``.  Returns the number of chunks computed by this call (0 when
    the sweep was already complete)."""
    from ..api import prepare_scene, trace

    os.makedirs(cfg.output_dir, exist_ok=True)
    rx_positions = np.asarray(rx_positions, np.float32).reshape(-1, 3)
    tx_positions = np.asarray(tx_positions, np.float32).reshape(-1, 3)
    rx_velocities = (np.zeros_like(rx_positions) if rx_velocities is None
                     else np.asarray(rx_velocities, np.float32))
    n = rx_positions.shape[0]
    n_chunks = -(-n // cfg.chunk_size)

    manifest = {
        "num_rx": int(n), "num_tx": int(tx_positions.shape[0]),
        "chunk_size": cfg.chunk_size, "num_chunks": n_chunks,
        "carrier_frequency_ghz": cfg.carrier_frequency_ghz,
        "num_paths": cfg.tracer.num_paths,
        "num_bounces": cfg.tracer.num_bounces,
    }
    with open(os.path.join(cfg.output_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    tris = prepare_scene(scene, device=device)
    mats = (materials if materials is not None
            else default_materials(tris.device))
    computed = 0
    for ci in range(n_chunks):
        path = _chunk_path(cfg.output_dir, ci)
        lo = ci * cfg.chunk_size
        hi = min(lo + cfg.chunk_size, n)
        if _chunk_valid(path, hi - lo):
            continue
        rx_c = rx_positions[lo:hi]
        rxv_c = rx_velocities[lo:hi]
        pad = cfg.chunk_size - (hi - lo)
        if pad:
            rx_c = np.concatenate([rx_c, np.zeros((pad, 3), np.float32)])
            rxv_c = np.concatenate([rxv_c, np.zeros((pad, 3), np.float32)])
        with torch.no_grad():
            res = trace(tris, rx_c, tx_positions, rxv_c, tx_velocities,
                        cfg.carrier_frequency_ghz, config=cfg.tracer,
                        materials=mats)
        k = hi - lo
        tmp = path + ".tmp.npz"
        np.savez(tmp,
                 rx_positions=rx_positions[lo:hi],
                 a_te=_host(res.scatter.a_te, k),
                 a_tm=_host(res.scatter.a_tm, k),
                 tau=_host(res.scatter.tau, k),
                 freq_shift=_host(res.scatter.freq_shift, k),
                 los_a_te=_host(res.los.a_te, k),
                 los_tau=_host(res.los.tau, k))
        os.replace(tmp, path)   # atomic: a crash never leaves a bad chunk
        computed += 1
        if progress:
            print(f"chunk {ci + 1}/{n_chunks} done", flush=True)
    return computed


def load_sweep_results(output_dir: str) -> Iterator[dict]:
    """Yield per-chunk result dicts in order."""
    with open(os.path.join(output_dir, "manifest.json")) as f:
        manifest = json.load(f)
    for ci in range(manifest["num_chunks"]):
        with np.load(_chunk_path(output_dir, ci)) as z:
            yield {k: z[k] for k in z.files}
