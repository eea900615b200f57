"""A synthetic scene: a seeded random triangle soup.

A frozen numpy copy of ``hermespy_rt_tpu_torch/scene/builders.py::
random_soup_scene`` at commit 4304014e, so that a change to the program's
builders cannot move the yardstick.  The configuration's own seed fixes the
geometry; the run's seed does not touch it.
"""
from __future__ import annotations

import numpy as np


def generate(params: dict, workdir: str) -> dict:
    """``params``: ``num_triangles``, ``seed``, ``extent``, ``tri_size``,
    ``material``.  Returns the meshes as ``(vertices f32[V, 3], faces
    u32[F, 3], material id)`` for both sides, no scene file and no
    building footprints."""
    n = int(params["num_triangles"])
    rng = np.random.default_rng(int(params["seed"]))
    centers = rng.uniform(-params["extent"], params["extent"], size=(n, 1, 3))
    offsets = rng.normal(scale=params["tri_size"], size=(n, 3, 3))
    verts = (centers + offsets).astype(np.float32).reshape(-1, 3)
    faces = np.arange(n * 3, dtype=np.uint32).reshape(-1, 3)
    return dict(meshes=[(verts, faces, int(params["material"]))],
                file=None, footprints=np.zeros((0, 4)))
