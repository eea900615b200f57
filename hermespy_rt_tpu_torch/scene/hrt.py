"""HRT binary scene reader and writer, byte-compatible with the reference
serializer.

Layout: magic ``b"HRT"``, ``u32 num_meshes``, then per mesh ``u32
num_vertices``, ``f32[num_vertices, 3]`` vertices, ``u32 num_triangles``,
``u32[num_triangles, 3]`` indices, ``u32 material_index`` and ``f32[3]``
velocity, little-endian and packed.  :func:`save_hrt` writes the bytes
:func:`hermespy_rt_tpu.scene.hrt.save_hrt` writes for the same scene, and
files of either read back unchanged.
"""
from __future__ import annotations

import io
import struct
from typing import Union

import numpy as np

from .model import HostMesh, HostScene

__all__ = ["load_hrt", "save_hrt", "HrtFormatError"]

_MAGIC = b"HRT"
MAX_MESHES = 1000


class HrtFormatError(ValueError):
    """Malformed HRT file."""


def _read_exact(f, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise HrtFormatError(f"truncated HRT file: wanted {n} bytes, got {len(data)}")
    return data


def load_hrt(path_or_file: Union[str, io.IOBase]) -> HostScene:
    """Load a scene from an HRT file (path or binary file object)."""
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file, "rb") as f:
            return load_hrt(f)
    f = path_or_file
    if _read_exact(f, 3) != _MAGIC:
        raise HrtFormatError("bad magic, not an HRT file")
    (num_meshes,) = struct.unpack("<I", _read_exact(f, 4))
    if num_meshes == 0:
        raise HrtFormatError("scene has no meshes")
    if num_meshes > MAX_MESHES:
        raise HrtFormatError(f"scene has too many meshes ({num_meshes} > {MAX_MESHES})")
    meshes = []
    for _ in range(num_meshes):
        (nv,) = struct.unpack("<I", _read_exact(f, 4))
        vs = np.frombuffer(_read_exact(f, 12 * nv), dtype="<f4").reshape(nv, 3)
        (nt,) = struct.unpack("<I", _read_exact(f, 4))
        idx = np.frombuffer(_read_exact(f, 12 * nt), dtype="<u4").reshape(nt, 3)
        (mat,) = struct.unpack("<I", _read_exact(f, 4))
        vel = np.frombuffer(_read_exact(f, 12), dtype="<f4").copy()
        meshes.append(HostMesh(vertices=vs.copy(), indices=idx.copy(),
                               material_index=int(mat), velocity=vel))
    return HostScene(meshes=meshes)


def save_hrt(scene: HostScene, path_or_file: Union[str, io.IOBase]) -> None:
    """Write a scene in HRT format (path or binary file object)."""
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file, "wb") as f:
            save_hrt(scene, f)
            return
    f = path_or_file
    f.write(_MAGIC)
    f.write(struct.pack("<I", scene.num_meshes))
    for m in scene.meshes:
        f.write(struct.pack("<I", m.num_vertices))
        f.write(np.ascontiguousarray(m.vertices, dtype="<f4").tobytes())
        f.write(struct.pack("<I", m.num_triangles))
        f.write(np.ascontiguousarray(m.indices, dtype="<u4").tobytes())
        f.write(struct.pack("<I", m.material_index))
        f.write(np.asarray(m.velocity, dtype="<f4").tobytes())
