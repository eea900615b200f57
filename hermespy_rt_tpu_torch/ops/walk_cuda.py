"""The hand-written CUDA walk kernels and their launch wrappers.

``csrc/walk.cu`` holds ``walk_prepass_kernel``, which replaces the TPU
kernel ``hermespy_rt_tpu/ops/intersect_pallas.py::_prepass_kernel`` and the
count and stable sort after it, and ``walk_kernel``, which replaces
``::_kernel_walk_res`` and ``::_kernel_walk`` (see the note at the top of
that file and ``ops/walk.py``).  They are built with the package's other
kernels by :mod:`._cuda_build` at first use.

:data:`walk_prepass` and :data:`walk` are the wrappers.  Given CPU tensors
they run the plain versions (:func:`~.walk.visit_rows` of
:func:`~.walk.prepass_plain`, and :func:`~.walk.walk_plain`); given CUDA
tensors they launch the kernel on the current stream or raise.  Each counts
its launches in ``launches``.  :func:`walk_query` composes a nearest-hit (or
any-hit) query: the limits, the prepass into visit rows, and the walk.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.profiling import LaunchCounter
from ._cuda_build import (CSRC, LIBRARY, OperandChecker, cuda_device,
                          raise_on)
from .walk import (MAX_BOXES, WALK_BLOCK_RAYS, SceneWalk, prepass_plain,
                   query_limits, visit_rows, walk_plain)

__all__ = ["walk_prepass", "walk", "walk_query", "WalkPrepassKernel",
           "WalkKernel", "SOURCE"]

SOURCE = CSRC / "walk.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_PREPASS_ARGTYPES = (_P, _P, _P, _I, _I, _P, _I, _P, _P)
_WALK_ARGTYPES = (_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                  _P, _P)
_KERNEL_RAYS = 256    # rays per tile of both kernels (csrc/walk.cu kRays)
_KERNEL_MAX_TILE = 256


def _on_card(name, x):
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    cuda_device(name, x)
    return True


class WalkPrepassKernel(LaunchCounter):
    """Launch wrapper of the prepass kernel (one per process)."""

    def __init__(self):
        super().__init__("walk_prepass")
        self._fn = None

    def __call__(self, o: torch.Tensor, d: torch.Tensor, lim: torch.Tensor,
                 boxes: torch.Tensor, block_rays: int = WALK_BLOCK_RAYS
                 ) -> torch.Tensor:
        """The packed visit rows ``int32[nRT, 1 + C]`` of rays ``o``, ``d``
        ``f32[R, 3]`` with padded limits ``lim`` against ``boxes``
        ``f32[C, 6]``, ``C <= MAX_BOXES``: the rows of
        ``visit_rows(*prepass_plain(...))``."""
        C = boxes.shape[0]
        if C > MAX_BOXES:
            raise ValueError(f"walk_prepass: {C} coarse boxes, the prepass "
                             f"takes at most MAX_BOXES = {MAX_BOXES}")
        if not _on_card("walk_prepass", o):
            return visit_rows(*prepass_plain(o, d, lim, boxes, block_rays))
        if block_rays != _KERNEL_RAYS:
            raise ValueError(f"walk_prepass: the kernel takes ray tiles of "
                             f"{_KERNEL_RAYS}, not {block_rays}")
        dev, R = o.device, o.shape[0]
        n_rt = lim.shape[0] // _KERNEL_RAYS
        check = OperandChecker("walk_prepass", dev)
        check("o", o, torch.float32, (R, 3))
        check("d", d, torch.float32, (R, 3))
        check("lim", lim, torch.float32, (n_rt * _KERNEL_RAYS,))
        check("boxes", boxes, torch.float32, (C, 6))
        if n_rt * _KERNEL_RAYS < R:
            raise ValueError("walk_prepass: lim is shorter than the rays")
        if C == 0 or n_rt == 0:
            return torch.zeros((n_rt, 1 + C), dtype=torch.int32, device=dev)
        if self._fn is None:
            self._fn = LIBRARY.function("hrt_walk_prepass", _PREPASS_ARGTYPES)
        visits = torch.empty((n_rt, 1 + C), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(o.data_ptr(), d.data_ptr(), lim.data_ptr(), R, n_rt,
                           boxes.data_ptr(), C, visits.data_ptr(), stream)
        raise_on("walk_prepass", err)
        self.launched()
        return visits


class WalkKernel(LaunchCounter):
    """Launch wrapper of the walk kernel (one per process)."""

    def __init__(self):
        super().__init__("walk")
        self._fn = None

    def __call__(self, o: torch.Tensor, d: torch.Tensor, lim: torch.Tensor,
                 scene: SceneWalk, visits: torch.Tensor,
                 exclude: Optional[torch.Tensor] = None,
                 any_hit: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(t f32[R], idx i32[R])`` of the walk over ``visits``
        (:data:`walk_prepass`); the semantics of
        :func:`~.walk.walk_plain`."""
        if not _on_card("walk", o):
            return walk_plain(o, d, scene, visits, lim, exclude=exclude,
                              any_hit=any_hit)
        if scene.block_rays != _KERNEL_RAYS:
            raise ValueError(f"walk: the kernel takes ray tiles of "
                             f"{_KERNEL_RAYS}, not {scene.block_rays}")
        if not 0 < scene.block_tris <= _KERNEL_MAX_TILE:
            raise ValueError(f"walk: fine tiles of 1..{_KERNEL_MAX_TILE} "
                             f"triangles, not {scene.block_tris}")
        dev, R = o.device, o.shape[0]
        n_rt = lim.shape[0] // _KERNEL_RAYS
        t_pad = scene.n_tiles * scene.block_tris
        check = OperandChecker("walk", dev)
        check("o", o, torch.float32, (R, 3))
        check("d", d, torch.float32, (R, 3))
        check("lim", lim, torch.float32, (n_rt * _KERNEL_RAYS,))
        if n_rt * _KERNEL_RAYS < R:
            raise ValueError("walk: lim is shorter than the rays")
        check("records", scene.records, torch.float32, (t_pad, 12))
        if scene.records.data_ptr() % 16:
            raise ValueError("walk: records are not 16-byte aligned")
        check("aabbs", scene.aabbs, torch.float32, (scene.n_tiles, 6))
        check("visits", visits, torch.int32, (n_rt, 1 + scene.n_boxes))
        if scene.n_boxes * scene.group != scene.n_tiles:
            raise ValueError("walk: boxes and fine tiles do not match")
        if exclude is not None:
            check("exclude", exclude, torch.int32, (R,))
        if self._fn is None:
            self._fn = LIBRARY.function("hrt_walk", _WALK_ARGTYPES)
        t_out = torch.empty((R,), dtype=torch.float32, device=dev)
        idx_out = torch.empty((R,), dtype=torch.int32, device=dev)
        if R == 0:
            return t_out, idx_out
        with torch.cuda.device(dev):
            # the ray tiles with the longest visit rows start first, so that
            # no long one is left running alone at the end
            order = torch.argsort(visits[:, 0], descending=True,
                                  stable=True)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(
                o.data_ptr(), d.data_ptr(), lim.data_ptr(),
                None if exclude is None else exclude.data_ptr(), R, n_rt,
                scene.records.data_ptr(), scene.aabbs.data_ptr(),
                visits.data_ptr(), visits.shape[1],
                scene.group, scene.block_tris, int(bool(any_hit)),
                order.data_ptr(), t_out.data_ptr(), idx_out.data_ptr(),
                stream)
        raise_on("walk", err)
        self.launched()
        return t_out, idx_out


walk_prepass = WalkPrepassKernel()
walk = WalkKernel()


def walk_query(o: torch.Tensor, d: torch.Tensor, scene: SceneWalk,
               exclude: Optional[torch.Tensor] = None, t_max=None,
               live: Optional[torch.Tensor] = None, any_hit: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest hit of rays ``(o, d)`` f32[R, 3] through the walk, with the
    semantics of :func:`~.intersect.intersect_torch`: ``exclude``,
    ``t_max`` (scalar or f32[R]) and ``live`` as there.  ``any_hit`` (used
    only with ``t_max``, as in the JAX package) lets a ray stop at its first
    hit within ``t_max``: whether a ray has a hit is the nearest query's
    answer, but ``(t, idx)`` may name another hit than the nearest."""
    lim = query_limits(o.shape[0], scene.block_rays, t_max=t_max, live=live,
                       device=o.device)
    visits = walk_prepass(o, d, lim, scene.boxes, scene.block_rays)
    return walk(o, d, lim, scene, visits, exclude=exclude,
                any_hit=any_hit and t_max is not None)
