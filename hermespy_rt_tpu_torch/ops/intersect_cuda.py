"""The hand-written CUDA nearest-hit kernel and its launch wrapper.

``csrc/intersect.cu`` replaces the TPU kernels
``hermespy_rt_tpu/ops/intersect_pallas.py::_kernel`` and ``::_kernel_flags``
(see the note at the top of that file).  It is built with the package's
other kernels by :mod:`._cuda_build` (one ``nvcc`` call for ``sm_90a``,
``-fmad=false``, no fast math, a ``ctypes`` binding) at first use.

:data:`nearest_hit` is the wrapper.  Given CPU tensors it runs the plain
torch twin :func:`~hermespy_rt_tpu_torch.ops.intersect.intersect_torch`;
given CUDA tensors it launches the kernel on the current stream or raises.
Its ``launches`` count goes up by one per kernel launch and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._cuda_build import CSRC, LIBRARY
from .intersect import intersect_torch

__all__ = ["nearest_hit", "NearestHitKernel", "SOURCE"]

SOURCE = CSRC / "intersect.cu"
_P = ctypes.c_void_p
_ARGTYPES = (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P,
             ctypes.c_float, _P, _P, _P, _P)


class NearestHitKernel:
    """Launch wrapper of the nearest-hit kernel (one per process)."""

    def __init__(self):
        self.launches = 0
        self._fn = None

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

        if self._fn is None:
            self._fn = LIBRARY.function("hrt_nearest_hit", _ARGTYPES)
        t_out = torch.empty((R,), dtype=torch.float32, device=dev)
        idx_out = torch.empty((R,), dtype=torch.int32, device=dev)
        if R == 0:
            return t_out, idx_out
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(
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
