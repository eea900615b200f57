"""Procedural scenes (numpy), identical to :mod:`hermespy_rt_tpu.scene.builders`:
the reference's 10x10x5 m concrete box and 1x1 m reflector plate, a ground
plane and a seeded random triangle soup."""
from __future__ import annotations

import numpy as np

from ..materials import MATERIAL_CONCRETE
from .model import HostMesh, HostScene

__all__ = ["box_scene", "simple_reflector_scene", "ground_plane_scene",
           "random_soup_scene"]


def box_scene() -> HostScene:
    """10x10x5 m concrete box, winding as in the reference."""
    vs = np.array([
        [5, 5, 0], [-5, 5, 0], [-5, -5, 0], [5, -5, 0],
        [5, 5, 5], [-5, 5, 5], [-5, -5, 5], [5, -5, 5],
    ], np.float32)
    idx = np.array([
        [0, 1, 2], [0, 2, 3], [0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],
        [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0], [4, 7, 6], [4, 6, 5],
    ], np.uint32)
    return HostScene([HostMesh(vs, idx, material_index=MATERIAL_CONCRETE, name="box")])


def simple_reflector_scene() -> HostScene:
    """1x1 m concrete plate at z=0."""
    vs = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0], [-0.5, 0.5, 0]],
                  np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    return HostScene([HostMesh(vs, idx, material_index=MATERIAL_CONCRETE,
                               name="reflector")])


def ground_plane_scene(half_extent: float = 100.0,
                       material_index: int = MATERIAL_CONCRETE) -> HostScene:
    vs = np.array([[-half_extent, -half_extent, 0], [half_extent, -half_extent, 0],
                   [half_extent, half_extent, 0], [-half_extent, half_extent, 0]],
                  np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    return HostScene([HostMesh(vs, idx, material_index=material_index, name="ground")])


def random_soup_scene(num_triangles: int, seed: int = 0, extent: float = 50.0,
                      tri_size: float = 2.0) -> HostScene:
    """Random triangle soup for kernel stress tests and benchmarks."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, size=(num_triangles, 1, 3))
    offsets = rng.normal(scale=tri_size, size=(num_triangles, 3, 3))
    verts = (centers + offsets).astype(np.float32).reshape(-1, 3)
    idx = np.arange(num_triangles * 3, dtype=np.uint32).reshape(-1, 3)
    return HostScene([HostMesh(verts, idx, material_index=MATERIAL_CONCRETE,
                               name="soup")])
