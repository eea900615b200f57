"""Public user-facing API of the PyTorch port.

:func:`compute_paths` takes the reference's ten arguments (scene, RX/TX
positions and velocities, carrier frequency in GHz, counts) and returns
``(los, scatter)`` :class:`~hermespy_rt_tpu_torch.tracer.ChannelInfo`
objects with the reference's shapes: directions ``(num_rx, num_tx,
num_rays, 3)``, complex64 gains and f32 ``tau``/``freq_shift``
``(num_rx, num_tx, num_rays)``.  :func:`trace` is the extended entry point
(scene objects, material tables, configs, ray segments).  Every entry point
takes the ``device`` it runs on, the card (``"cuda"``) unless the caller asks
for the CPU; tensors are made there.  A ``"cuda"`` call on a machine without
a card raises, as torch does: nothing falls back to the CPU.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .config import TracerConfig
from .materials import MaterialTable, default_materials
from .scene.model import HostScene, TriangleSoA, flatten_scene
from .scene.sionna import load_scene
from .tracer import ChannelInfo, PathsResult, launch_directions, trace_paths

__all__ = ["compute_paths", "trace", "prepare_scene", "load_scene"]

SceneLike = Union[str, HostScene, TriangleSoA]


def prepare_scene(scene: SceneLike, pad_to: int = 128,
                  sort_triangles: bool = False,
                  device="cuda") -> TriangleSoA:
    """Resolve a path / host scene / prepared SoA to a TriangleSoA on
    ``device`` (a prepared SoA is returned as it is)."""
    if isinstance(scene, TriangleSoA):
        return scene
    host = scene if isinstance(scene, HostScene) else load_scene(scene)
    return flatten_scene(host, pad_to=pad_to, sort_triangles=sort_triangles,
                         device=device)


@lru_cache(maxsize=16)
def _cached_dirs(num_paths: int, order: str, device: str) -> torch.Tensor:
    """Launch directions per (paths, order, device), made once: they are
    host f64 trig over every path, which at 2^20 paths outweighs the traced
    part of a trace (PERF.md).  Callers only read the tensor."""
    return launch_directions(num_paths, order, device)


def _as_f32(x, device) -> torch.Tensor:
    """``x`` as an f32 tensor on ``device``.  A tensor stays one, so a
    gradient reaches it (``torch.as_tensor`` keeps autograd, and a cast or
    a move is differentiable too); anything else goes through numpy."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def trace(scene: SceneLike,
          rx_positions, tx_positions,
          rx_velocities=None, tx_velocities=None,
          carrier_frequency: float = 3.0,
          config: Optional[TracerConfig] = None,
          materials: Optional[MaterialTable] = None,
          device="cuda") -> PathsResult:
    """Full-featured tracing entry point on ``device`` (or, for a prepared
    TriangleSoA, on the device that holds it).  Positions, velocities and
    the carrier frequency (GHz) given as tensors keep their autograd
    history, so gradients reach them."""
    cfg = config or TracerConfig()
    if not isinstance(scene, TriangleSoA):
        # Morton-sort large scenes outside reference parity, as the JAX
        # package does; parity runs keep file order (it decides exact ties)
        host = scene if isinstance(scene, HostScene) else load_scene(scene)
        scene = flatten_scene(
            host, sort_triangles=(cfg.parity != "reference"
                                  and host.num_triangles >= 4096),
            device=device)
    tris = scene  # a prepared TriangleSoA runs on the device that holds it
    mats = (materials if materials is not None
            else default_materials(tris.device))
    rx_pos = _as_f32(rx_positions, tris.device).reshape(-1, 3)
    tx_pos = _as_f32(tx_positions, tris.device).reshape(-1, 3)
    rx_vel = (torch.zeros_like(rx_pos) if rx_velocities is None
              else _as_f32(rx_velocities, tris.device).reshape(-1, 3))
    tx_vel = (torch.zeros_like(tx_pos) if tx_velocities is None
              else _as_f32(tx_velocities, tris.device).reshape(-1, 3))
    dirs = _cached_dirs(cfg.num_paths, cfg.resolved_launch_order,
                        str(tris.device))
    freq = (_as_f32(carrier_frequency, tris.device)
            if isinstance(carrier_frequency, torch.Tensor)
            else float(carrier_frequency))
    return trace_paths(tris, mats, rx_pos, tx_pos, rx_vel, tx_vel, freq, cfg,
                       launch_dirs=dirs)


def compute_paths(mesh_filepath: SceneLike,
                  rx_positions, tx_positions,
                  rx_velocities, tx_velocities,
                  carrier_frequency: float,
                  num_rx: int, num_tx: int,
                  num_paths: int, num_bounces: int,
                  device="cuda",
                  **kwargs) -> Tuple[ChannelInfo, ChannelInfo]:
    """Reference-compatible entry point: the reference's ten arguments, plus
    the ``device`` to run on.  Returns ``(los, scatter)``, without gradient
    (use :func:`trace` with a :class:`MaterialTable` for gradients).  Extra
    keyword arguments go to :class:`TracerConfig` (e.g.
    ``parity="physical"``, ``backend="torch"``, ``shade="fused"``)."""
    rx_positions = np.asarray(rx_positions, np.float32).reshape(-1, 3)
    tx_positions = np.asarray(tx_positions, np.float32).reshape(-1, 3)
    if rx_positions.shape[0] != num_rx:
        raise ValueError(f"rx_positions has {rx_positions.shape[0]} rows, expected {num_rx}")
    if tx_positions.shape[0] != num_tx:
        raise ValueError(f"tx_positions has {tx_positions.shape[0]} rows, expected {num_tx}")
    cfg = TracerConfig(num_paths=num_paths, num_bounces=num_bounces, **kwargs)
    # the default material table is made here and nothing outside can reach
    # it, so no autograd graph is kept
    with torch.no_grad():
        result = trace(mesh_filepath, rx_positions, tx_positions,
                       rx_velocities, tx_velocities, carrier_frequency,
                       config=cfg, device=device)
    return result.los, result.scatter
