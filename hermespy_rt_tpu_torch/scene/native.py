"""ctypes bindings for the C++ scene I/O library (``csrc/hrt_io.cpp``).

HRT reading and writing, the binary PLY reader and the SoA flattening in
native code, each with a Python twin (:mod:`.hrt`, :func:`.sionna.load_ply`,
:func:`.model.flatten_scene`).  The library is built on first use by one
``g++`` call from the package's own ``csrc/hrt_io.cpp`` into the
git-ignored ``_build/`` directory, under a name that carries a hash of the
source and the flags.  Nothing falls back: :func:`native_available` says
whether the library builds and loads, and every native function raises
:class:`NativeIOError` when it does not, or when the library reports an
error.  Only the want of a compiler (:func:`compiler`) excuses a caller
from the native path; a compiler that fails is an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from .model import HostMesh, HostScene

__all__ = ["native_available", "compiler", "load_hrt_native", "save_hrt_native",
           "load_ply_native", "flatten_arrays_native", "NativeIOError",
           "SOURCE"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "hrt_io.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared")

_lib = None
_error: Optional[str] = None


class NativeIOError(RuntimeError):
    """The native library is unavailable or reported an error."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libhrt_io_{h.hexdigest()[:16]}.so"


def compiler() -> Optional[str]:
    """The C++ compiler that builds the library (``$CXX``, else ``g++``)
    where it is on ``PATH``, else None."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _build() -> Path:
    path = library_path()
    if path.exists():
        return path
    cxx = compiler()
    if cxx is None:
        raise NativeIOError("no C++ compiler: "
                            f"{os.environ.get('CXX') or 'g++'} is not on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", out, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeIOError(f"{cxx} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(out, path)
    return path


def _get_lib() -> ctypes.CDLL:
    """The library, built and loaded on first use; raises
    :class:`NativeIOError` (the first failure's, every time) when it is not
    available."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise NativeIOError(_error)
    try:
        lib = ctypes.CDLL(str(_build()))
    except (NativeIOError, OSError, subprocess.SubprocessError) as e:
        _error = f"native scene I/O unavailable: {e}"
        raise NativeIOError(_error) from e
    lib.hrt_last_error.restype = ctypes.c_char_p
    lib.hrt_scene_new.restype = ctypes.c_void_p
    lib.hrt_scene_free.argtypes = [ctypes.c_void_p]
    lib.hrt_scene_num_meshes.argtypes = [ctypes.c_void_p]
    lib.hrt_scene_num_triangles.argtypes = [ctypes.c_void_p]
    lib.hrt_load.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.hrt_save.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.hrt_mesh_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_float)]
    lib.hrt_mesh_copy.argtypes = [ctypes.c_void_p, ctypes.c_int, f32p, u32p]
    lib.hrt_scene_add_mesh.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_uint32, u32p, ctypes.c_uint32,
        ctypes.c_uint32, f32p]
    lib.hrt_flatten.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                f32p, f32p, f32p, f32p, f32p, i32p, i32p]
    lib.hrt_load_ply.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_uint32, f32p]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _get_lib()
    except NativeIOError:
        return False
    return True


def _check(lib, rc: int):
    if rc != 0:
        raise NativeIOError(lib.hrt_last_error().decode())


def _scene_to_handle(lib, scene: HostScene):
    h = lib.hrt_scene_new()
    for m in scene.meshes:
        lib.hrt_scene_add_mesh(
            h, np.ascontiguousarray(m.vertices, np.float32), m.num_vertices,
            np.ascontiguousarray(m.indices, np.uint32), m.num_triangles,
            m.material_index, np.ascontiguousarray(m.velocity, np.float32))
    return h


def _handle_to_scene(lib, h) -> HostScene:
    meshes = []
    for i in range(lib.hrt_scene_num_meshes(h)):
        nv, nt, mat = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
        vel = (ctypes.c_float * 3)()
        _check(lib, lib.hrt_mesh_info(h, i, ctypes.byref(nv),
                                      ctypes.byref(nt), ctypes.byref(mat),
                                      vel))
        vs = np.empty((nv.value, 3), np.float32)
        idx = np.empty((nt.value, 3), np.uint32)
        _check(lib, lib.hrt_mesh_copy(h, i, vs, idx))
        meshes.append(HostMesh(vs, idx, material_index=int(mat.value),
                               velocity=np.array(vel, np.float32)))
    return HostScene(meshes)


def load_hrt_native(path: str) -> HostScene:
    lib = _get_lib()
    h = lib.hrt_scene_new()
    try:
        _check(lib, lib.hrt_load(str(path).encode(), h))
        return _handle_to_scene(lib, h)
    finally:
        lib.hrt_scene_free(h)


def save_hrt_native(scene: HostScene, path: str) -> None:
    lib = _get_lib()
    h = _scene_to_handle(lib, scene)
    try:
        _check(lib, lib.hrt_save(str(path).encode(), h))
    finally:
        lib.hrt_scene_free(h)


def load_ply_native(path: str, material_index: int = 0,
                    velocity=(0.0, 0.0, 0.0)) -> HostMesh:
    """One binary little-endian PLY as a mesh of ``material_index`` moving
    at ``velocity``."""
    lib = _get_lib()
    h = lib.hrt_scene_new()
    try:
        _check(lib, lib.hrt_load_ply(str(path).encode(), h, material_index,
                                     np.asarray(velocity, np.float32)))
        return _handle_to_scene(lib, h).meshes[0]
    finally:
        lib.hrt_scene_free(h)


def flatten_arrays_native(scene: HostScene, pad_triangles: int):
    """Native SoA flattening: numpy ``(v0, e1, e2, normal, velocity,
    material, mesh_id)`` padded to ``pad_triangles`` rows, in file order."""
    lib = _get_lib()
    h = _scene_to_handle(lib, scene)
    try:
        v0 = np.empty((pad_triangles, 3), np.float32)
        e1, e2, normal, velocity = (np.empty_like(v0) for _ in range(4))
        material = np.empty(pad_triangles, np.int32)
        mesh_id = np.empty(pad_triangles, np.int32)
        _check(lib, lib.hrt_flatten(h, pad_triangles, v0, e1, e2, normal,
                                    velocity, material, mesh_id))
        return v0, e1, e2, normal, velocity, material, mesh_id
    finally:
        lib.hrt_scene_free(h)
