"""Scene data model: host-side meshes (numpy) and the triangle SoA (torch).

The counterpart of :mod:`hermespy_rt_tpu.scene.model`.  A scene is a list of
triangle meshes, each with vertices, vertex indices, a material id and a
rigid-body velocity.  :func:`flatten_scene` turns it into a padded
structure-of-arrays :class:`TriangleSoA` on one device, with the same padding,
normals and optional Morton order as the JAX package, so both packages trace
the same triangles in the same order.  Padding triangles are all zero: their
Möller–Trumbore determinant is exactly 0, so they never hit.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

__all__ = ["HostMesh", "HostScene", "TriangleSoA", "flatten_scene"]


@dataclasses.dataclass
class HostMesh:
    """One triangle mesh on the host (reference ``Mesh`` minus normals)."""

    vertices: np.ndarray          # float32[V, 3]
    indices: np.ndarray           # uint32[F, 3]
    material_index: int = 0
    velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    name: str = ""

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32).reshape(-1, 3)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.uint32).reshape(-1, 3)
        self.velocity = np.asarray(self.velocity, dtype=np.float32).reshape(3)

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass
class HostScene:
    """A collection of meshes (reference ``Scene``)."""

    meshes: List[HostMesh]

    @property
    def num_meshes(self) -> int:
        return len(self.meshes)

    @property
    def num_triangles(self) -> int:
        return sum(m.num_triangles for m in self.meshes)


@dataclasses.dataclass(frozen=True)
class TriangleSoA:
    """Flattened scene geometry on one device.

    ``v0/e1/e2`` are the Möller–Trumbore basis (first vertex, two edges),
    ``normal`` the unit geometric normal ``normalize(e1 x e2)``; ``material``
    and ``velocity`` are broadcast per triangle from their mesh.  Rows
    ``>= num_triangles`` are zero padding.
    """

    v0: torch.Tensor        # f32[T, 3]
    e1: torch.Tensor        # f32[T, 3]
    e2: torch.Tensor        # f32[T, 3]
    normal: torch.Tensor    # f32[T, 3]
    velocity: torch.Tensor  # f32[T, 3]
    material: torch.Tensor  # i64[T]
    mesh_id: torch.Tensor   # i64[T]
    num_triangles: int = 0

    @property
    def pad_triangles(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Spatial sort permutation: 3x10-bit Morton codes of ``centroids``."""
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    q = np.clip(((centroids - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):  # interleave 10 bits with 2-bit gaps
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def flatten_scene(scene: HostScene, pad_to: int = 128,
                  sort_triangles: bool = False,
                  device="cuda") -> TriangleSoA:
    """Flatten all meshes into a padded :class:`TriangleSoA` on ``device``.

    Normals are computed once, in float32 and in the reference's operation
    order (``normalize(cross(v2 - v1, v3 - v1))``).  ``sort_triangles``
    reorders triangles along a Morton curve; it is off by default because the
    order decides which triangle wins an exact tie.
    """
    v0s, e1s, e2s, mats, vels, mids = [], [], [], [], [], []
    for mi, mesh in enumerate(scene.meshes):
        if mesh.num_triangles == 0:
            continue
        tri = mesh.vertices[mesh.indices.astype(np.int64)]  # [F, 3, 3]
        v1, v2, v3 = tri[:, 0], tri[:, 1], tri[:, 2]
        v0s.append(v1)
        e1s.append(v2 - v1)
        e2s.append(v3 - v1)
        mats.append(np.full(mesh.num_triangles, mesh.material_index, np.int32))
        vels.append(np.broadcast_to(mesh.velocity, (mesh.num_triangles, 3)))
        mids.append(np.full(mesh.num_triangles, mi, np.int32))

    v0 = np.concatenate(v0s, axis=0).astype(np.float32)
    e1 = np.concatenate(e1s, axis=0).astype(np.float32)
    e2 = np.concatenate(e2s, axis=0).astype(np.float32)
    n_un = np.cross(e1, e2)
    norm = np.sqrt(np.sum(n_un * n_un, axis=-1, keepdims=True))
    normal = (n_un / norm).astype(np.float32)
    material = np.concatenate(mats, axis=0)
    velocity = np.concatenate(vels, axis=0).astype(np.float32)
    mesh_id = np.concatenate(mids, axis=0)

    if sort_triangles and v0.shape[0] > 1:
        perm = _morton_order(v0 + (e1 + e2) / 3.0)
        v0, e1, e2, normal = v0[perm], e1[perm], e2[perm], normal[perm]
        material, velocity, mesh_id = (material[perm], velocity[perm],
                                       mesh_id[perm])

    num_t = v0.shape[0]
    pad_t = _round_up(max(num_t, 1), pad_to)

    def pad(x, fill=0, dtype=None):
        out = np.full((pad_t,) + x.shape[1:], fill, dtype=x.dtype)
        out[:num_t] = x
        return torch.as_tensor(out, dtype=dtype, device=device)

    return TriangleSoA(
        v0=pad(v0), e1=pad(e1), e2=pad(e2), normal=pad(normal),
        velocity=pad(velocity), material=pad(material, dtype=torch.int64),
        mesh_id=pad(mesh_id, fill=-1, dtype=torch.int64), num_triangles=num_t,
    )
