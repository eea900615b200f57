"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ONE ``nvcc`` call for ``sm_90a``, with
``-fmad=false`` and without fast math (every product, sum, square root and
division rounded on its own, as the plain torch versions round them), into
one shared library with a plain C interface under the git-ignored
``hermespy_rt_tpu_torch/_build/``, and bound with ``ctypes``.  The library's
name carries a hash of every source, of the headers they share
(``csrc/*.cuh``) and of the flags, so an edited source is rebuilt.  Nothing
is built at import: the first launch, or :meth:`build`, builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

import torch

__all__ = ["KernelLibrary", "LIBRARY", "CSRC", "SOURCES", "HEADERS",
           "NVCC_FLAGS", "BUILD_DIR", "OperandChecker", "cuda_device",
           "raise_on"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


class KernelLibrary:
    """The one kernel library of the package (one per process)."""

    def __init__(self, sources: Sequence[Path] = SOURCES):
        self.sources = tuple(sources)
        self.build_log = ""
        self.build_seconds = None
        self._lib = None

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources + HEADERS:
            h.update(src.name.encode() + b"\0" + src.read_bytes())
        return BUILD_DIR / f"libhrt_kernels_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library if it is not built yet and load it.  Returns
        the library's path."""
        lib_path = self.path()
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                     *map(str, self.sources)],
                    capture_output=True, text=True, timeout=600)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{self.build_log}")
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self.build_seconds = time.perf_counter() - t0
        if self._lib is None:
            self._lib = ctypes.CDLL(str(lib_path))
        return lib_path

    def function(self, name: str, argtypes):
        """The C entry point ``name`` (built and loaded on first use), with
        its ``argtypes`` set and an int return (a ``cudaError_t``)."""
        if self._lib is None:
            self.build()
        fn = getattr(self._lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn


LIBRARY = KernelLibrary()


class OperandChecker:
    """A launch wrapper's operand checks against the device of its first
    operand: device, dtype, shape and contiguity; returns the pointer."""

    def __init__(self, name: str, dev: torch.device):
        self.name, self.dev = name, dev

    def __call__(self, arg: str, x: torch.Tensor, dtype, shape):
        if x.device != self.dev:
            raise ValueError(f"{self.name}: {arg} on {x.device}, "
                             f"expected {self.dev}")
        if x.dtype != dtype:
            raise ValueError(f"{self.name}: {arg} is {x.dtype}, want {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{self.name}: {arg} has shape "
                             f"{tuple(x.shape)}, want {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{self.name}: {arg} is not contiguous")
        return x.data_ptr()


def cuda_device(name: str, x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device


def raise_on(name: str, err: int):
    """Raise if a launch returned a nonzero ``cudaError``."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err}")
