"""Build the port's objects from the JAX package's parameters.

Both take plain numpy arrays keyed by field name (for example
``{f.name: np.asarray(getattr(table, f.name)) for f in
dataclasses.fields(table)}`` of a JAX ``MaterialTable`` or ``TriangleSoA``),
so this package never imports JAX, and the two packages compute on the same
parameters in comparisons.  They are the tests' harness, so unlike the
package's entry points (which default to the card) they default to the CPU,
where the JAX reference runs.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .materials import MATERIAL_FIELDS, MaterialTable
from .scene.model import TriangleSoA

__all__ = ["materials_from_jax", "soa_from_jax"]


def materials_from_jax(arrays: Mapping[str, object],
                       device="cpu") -> MaterialTable:
    """MaterialTable from the ten ``[M]`` columns ``a`` … ``s3_alpha``, of
    any row count ``M``."""
    return MaterialTable({f: np.asarray(arrays[f], np.float32)
                          for f in MATERIAL_FIELDS}, device=device)


def soa_from_jax(arrays: Mapping[str, object], device="cpu") -> TriangleSoA:
    """TriangleSoA from ``v0, e1, e2, normal, velocity`` (f32 ``[T, 3]``),
    ``material, mesh_id`` (int ``[T]``) and ``num_triangles`` (int)."""
    def f32(name):
        return torch.as_tensor(np.array(arrays[name], np.float32),
                               device=device)

    def i64(name):
        return torch.as_tensor(np.array(arrays[name], np.int64),
                               device=device)

    return TriangleSoA(
        v0=f32("v0"), e1=f32("e1"), e2=f32("e2"), normal=f32("normal"),
        velocity=f32("velocity"), material=i64("material"),
        mesh_id=i64("mesh_id"), num_triangles=int(arrays["num_triangles"]))
