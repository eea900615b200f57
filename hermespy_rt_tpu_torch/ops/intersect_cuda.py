"""The hand-written CUDA nearest-hit kernels and their launch wrappers.

``csrc/intersect.cu`` replaces the TPU kernels
``hermespy_rt_tpu/ops/intersect_pallas.py::_kernel`` and ``::_kernel_flags``
(``nearest_hit_kernel``) and ``::_kernel_culled``
(``nearest_hit_culled_kernel``; see the note at the top of that file): one
block of 256 rays packs its live rays, deals each staged tile's (live ray,
triangle) pairs over its warps, and stages the triangles as 48-byte records
(:func:`~.walk.triangle_records`) by bulk copies.  It is built with the
package's other kernels by :mod:`._cuda_build` (one ``nvcc`` call per
source for ``sm_90a``, ``-fmad=false``, no fast math, a ``ctypes`` binding)
at first use.

:data:`nearest_hit` is the wrapper.  Given CPU tensors it runs the plain
torch twin :func:`~hermespy_rt_tpu_torch.ops.intersect.intersect_torch`;
given CUDA tensors it launches the kernel on the current stream or raises.
Its ``launches`` count goes up by one per kernel launch and nowhere else.
:data:`nearest_hit_culled` is the culled kernel's wrapper, the same way: its
plain version is ``intersect_torch`` too (culling changes no decision but
at the walk's box edge, ``ops/walk.py``); the tiles' boxes come from
:func:`~.walk.cull_boxes`.  A query is one launch and nothing else on the
device, with no host synchronisation, given the scene's ``records``: the
tracer builds them once per scene (``tracer.py::_select_intersect``); a
wrapper builds them itself only when a caller passes none.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._cuda_build import (CSRC, LIBRARY, OperandChecker, cuda_device,
                          raise_on)
from .intersect import T_MAX, intersect_torch
from .walk import CULL_BLOCK_TRIS, triangle_records

__all__ = ["nearest_hit", "nearest_hit_culled", "NearestHitKernel",
           "NearestHitCulledKernel", "brute_block_rays", "SOURCE"]

SOURCE = CSRC / "intersect.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_BLOCK_RAYS = 256      # rays a block of the kernels (csrc/tile_scan.cuh kRays)
_MIN_BLOCK_RAYS = 32


def brute_block_rays(R: int, n_sm: int) -> int:
    """Rays a block of the brute kernel for a query of ``R`` rays on a card
    of ``n_sm`` SMs: 256, halved while the grid would hold fewer than 4
    blocks an SM, down to 32 (``csrc/intersect.cu`` point 6)."""
    rays = _BLOCK_RAYS
    while rays > _MIN_BLOCK_RAYS and -(-R // rays) < 4 * n_sm:
        rays //= 2
    return rays


def _launch_operands(name, o, d, tris, exclude, t_max, live, records):
    """Check a query's operands on the card and return ``(dev, records,
    head, tail)``: the triangle records (the scene's, built here for a
    caller that keeps none; the caller holds them until the launch, or their
    memory could go to its outputs), the kernel's leading arguments (o, d,
    records, R, T) and those after the culled kernel's boxes (exclude,
    t_max, the scalar limit, live)."""
    dev = cuda_device(name, o)
    R, T = o.shape[0], tris.v0.shape[0]
    check = OperandChecker(name, dev)
    check("o", o, torch.float32, (R, 3))
    check("d", d, torch.float32, (R, 3))
    if records is None:
        records = triangle_records(tris.v0.detach(), tris.e1.detach(),
                                   tris.e2.detach())
    check("records", records, torch.float32, (T, 12))
    if T and records.data_ptr() % 16:
        raise ValueError(f"{name}: records are not 16-byte aligned")
    if exclude is not None:
        check("exclude", exclude, torch.int32, (R,))
    if live is not None:
        check("live", live, torch.bool, (R,))
    t_max_ptr, t_max_scalar = None, T_MAX
    if isinstance(t_max, torch.Tensor):
        check("t_max", t_max, torch.float32, (R,))
        t_max_ptr = t_max.data_ptr()
    elif t_max is not None:
        t_max_scalar = float(t_max)
    head = (o.data_ptr(), d.data_ptr(), records.data_ptr(), R, T)
    tail = (None if exclude is None else exclude.data_ptr(), t_max_ptr,
            t_max_scalar, None if live is None else live.data_ptr())
    return dev, records, head, tail


class NearestHitKernel:
    """Launch wrapper of the nearest-hit kernel (one per process)."""

    _ARGTYPES = (_P, _P, _P, _I, _I, _I, _P, _P, _F, _P, _P, _P, _P)

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._n_sm = {}

    def __call__(self, o: torch.Tensor, d: torch.Tensor, tris,
                 exclude: Optional[torch.Tensor] = None, t_max=None,
                 live: Optional[torch.Tensor] = None,
                 chunk_size: int = 4096,
                 records: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Nearest hit of rays ``(o, d)`` f32[R, 3] against ``tris``; the
        semantics of :func:`intersect_torch` (``chunk_size`` applies to the
        CPU path only).  ``records`` are the scene's triangle records
        ``f32[T, 12]`` (:func:`~.walk.triangle_records`)."""
        if o.device.type == "cpu":
            return intersect_torch(o, d, tris, chunk_size=chunk_size,
                                   exclude=exclude, t_max=t_max, live=live)
        dev, records, head, tail = _launch_operands(
            "nearest_hit", o, d, tris, exclude, t_max, live, records)
        if self._fn is None:
            self._fn = LIBRARY.function("hrt_nearest_hit", self._ARGTYPES)
        R = head[3]
        t_out = torch.empty((R,), dtype=torch.float32, device=dev)
        idx_out = torch.empty((R,), dtype=torch.int32, device=dev)
        if R == 0:
            return t_out, idx_out
        if dev not in self._n_sm:
            self._n_sm[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        with torch.cuda.device(dev):
            err = self._fn(*head, brute_block_rays(R, self._n_sm[dev]), *tail,
                           t_out.data_ptr(), idx_out.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
        raise_on("nearest_hit", err)
        self.launches += 1
        return t_out, idx_out


nearest_hit = NearestHitKernel()


class NearestHitCulledKernel:
    """Launch wrapper of the culled nearest-hit kernel (one per process)."""

    _ARGTYPES = (_P, _P, _P, _I, _I, _P, _P, _P, _F, _P, _P, _P, _P, _P)

    def __init__(self):
        self.launches = 0
        self._fn = None

    def __call__(self, o: torch.Tensor, d: torch.Tensor, tris,
                 aabbs: torch.Tensor,
                 exclude: Optional[torch.Tensor] = None, t_max=None,
                 live: Optional[torch.Tensor] = None, chunk_size: int = 4096,
                 skipped: Optional[torch.Tensor] = None,
                 records: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Nearest hit with the semantics of :func:`intersect_torch`;
        ``aabbs`` f32[ceil(T / 64), 6] are the tiles' boxes
        (:func:`~.walk.cull_boxes`), ``records`` as for
        :data:`nearest_hit`.  A CUDA int64 ``skipped`` [1] gets the skipped
        (block of 256 rays, tile) pairs added."""
        if o.device.type == "cpu":
            return intersect_torch(o, d, tris, chunk_size=chunk_size,
                                   exclude=exclude, t_max=t_max, live=live)
        dev, records, head, tail = _launch_operands(
            "nearest_hit_culled", o, d, tris, exclude, t_max, live, records)
        check = OperandChecker("nearest_hit_culled", dev)
        check("aabbs", aabbs, torch.float32,
              (-(-head[4] // CULL_BLOCK_TRIS), 6))
        if skipped is not None:
            check("skipped", skipped, torch.int64, (1,))
        if self._fn is None:
            self._fn = LIBRARY.function("hrt_nearest_hit_culled",
                                        self._ARGTYPES)
        R = head[3]
        t_out = torch.empty((R,), dtype=torch.float32, device=dev)
        idx_out = torch.empty((R,), dtype=torch.int32, device=dev)
        if R == 0:
            return t_out, idx_out
        with torch.cuda.device(dev):
            err = self._fn(
                *head, aabbs.data_ptr(), *tail, t_out.data_ptr(),
                idx_out.data_ptr(),
                None if skipped is None else skipped.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        raise_on("nearest_hit_culled", err)
        self.launches += 1
        return t_out, idx_out


nearest_hit_culled = NearestHitCulledKernel()
