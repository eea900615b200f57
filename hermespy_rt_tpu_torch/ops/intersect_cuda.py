"""The hand-written CUDA nearest-hit kernel and its launch wrapper.

``csrc/intersect.cu`` replaces the TPU kernels
``hermespy_rt_tpu/ops/intersect_pallas.py::_kernel`` and ``::_kernel_flags``
(see the note at the top of that file).  It is compiled with ``nvcc`` for
``sm_90a``, with ``-fmad=false`` and without fast math, into a shared library
with a plain C interface under ``hermespy_rt_tpu_torch/_build/`` at first use,
and bound with ``ctypes``.  The library's name carries a hash of the source
and flags, so an edited source is rebuilt.

:data:`nearest_hit` is the wrapper.  Given CPU tensors it runs the plain
torch twin :func:`~hermespy_rt_tpu_torch.ops.intersect.intersect_torch`;
given CUDA tensors it launches the kernel on the current stream or raises.
Its ``launches`` count goes up by one per kernel launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import torch

from .intersect import intersect_torch

__all__ = ["nearest_hit", "NearestHitKernel", "SOURCE", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "intersect.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")
_P = ctypes.c_void_p


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


class NearestHitKernel:
    """Launch wrapper of the nearest-hit kernel (one per process)."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def build(self) -> Path:
        """Compile the kernel library if it is not built yet and load it.
        Returns the library path."""
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        lib_path = BUILD_DIR / f"libhrt_intersect_{tag[:16]}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                    capture_output=True, text=True, timeout=600)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{self.build_log}")
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        if self._lib is None:
            lib = ctypes.CDLL(str(lib_path))
            fn = lib.hrt_nearest_hit
            fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                           _P, _P, ctypes.c_float, _P, _P, _P, _P]
            fn.restype = ctypes.c_int
            self._lib = lib
        return lib_path

    def __call__(self, o: torch.Tensor, d: torch.Tensor, tris,
                 exclude: Optional[torch.Tensor] = None, t_max=None,
                 live: Optional[torch.Tensor] = None,
                 chunk_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
        """Nearest hit of rays ``(o, d)`` f32[R, 3] against ``tris``; the
        semantics of :func:`intersect_torch` (``chunk_size`` applies to the
        CPU path only)."""
        if o.device.type == "cpu":
            return intersect_torch(o, d, tris, chunk_size=chunk_size,
                                   exclude=exclude, t_max=t_max, live=live)
        if o.device.type != "cuda":
            raise ValueError(f"nearest_hit: unsupported device {o.device}")
        dev = o.device
        R = o.shape[0]
        T = tris.v0.shape[0]

        def check(name, x, dtype, shape):
            if x.device != dev:
                raise ValueError(f"nearest_hit: {name} on {x.device}, rays on {dev}")
            if x.dtype != dtype:
                raise ValueError(f"nearest_hit: {name} is {x.dtype}, want {dtype}")
            if tuple(x.shape) != shape:
                raise ValueError(f"nearest_hit: {name} has shape "
                                 f"{tuple(x.shape)}, want {shape}")
            if not x.is_contiguous():
                raise ValueError(f"nearest_hit: {name} is not contiguous")

        check("o", o, torch.float32, (R, 3))
        check("d", d, torch.float32, (R, 3))
        for name in ("v0", "e1", "e2"):
            check(name, getattr(tris, name), torch.float32, (T, 3))
        if exclude is not None:
            check("exclude", exclude, torch.int32, (R,))
        if live is not None:
            check("live", live, torch.bool, (R,))
        t_max_ptr, t_max_scalar = None, float("inf")
        if isinstance(t_max, torch.Tensor):
            check("t_max", t_max, torch.float32, (R,))
            t_max_ptr = t_max.data_ptr()
        elif t_max is not None:
            t_max_scalar = float(t_max)

        if self._lib is None:
            self.build()
        t_out = torch.empty((R,), dtype=torch.float32, device=dev)
        idx_out = torch.empty((R,), dtype=torch.int32, device=dev)
        if R == 0:
            return t_out, idx_out
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._lib.hrt_nearest_hit(
                o.data_ptr(), d.data_ptr(), tris.v0.data_ptr(),
                tris.e1.data_ptr(), tris.e2.data_ptr(), R, T,
                None if exclude is None else exclude.data_ptr(),
                t_max_ptr, t_max_scalar,
                None if live is None else live.data_ptr(),
                t_out.data_ptr(), idx_out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"nearest_hit: kernel launch failed with "
                               f"cudaError {err}")
        self.launches += 1
        return t_out, idx_out


nearest_hit = NearestHitKernel()
