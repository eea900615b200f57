"""Launch wrappers of the fused bounce kernels (``csrc/bounce_fused.cu``).

* :data:`bounce_pre` replaces ``hermespy_rt_tpu/ops/bounce_fused.py::
  _pre_fwd_kernel``;
* :data:`bounce_post` replaces ``::_post_fwd_kernel``;
* :data:`loop_bwd_slim` replaces ``::_loop_bwd_slim_kernel``.

Each takes the arguments of its plain version in :mod:`.bounce_fused`.
Given CPU tensors it runs that plain version; given CUDA tensors it checks
device, type, shape and contiguity, allocates the outputs, launches the
kernel on the current stream and raises on a nonzero ``cudaError``.  Its
``launches`` count goes up by one per kernel launch and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ._cuda_build import (CSRC, LIBRARY, OperandChecker, cuda_device,
                          raise_on)
from .bounce_fused import (TABLE_COLS, FusedSpec, PostOut, PreOut,
                           bounce_post_plain, bounce_pre_plain,
                           loop_bwd_slim_plain)
from .fresnel import ETA_FIELDS

__all__ = ["bounce_pre", "bounce_post", "loop_bwd_slim", "SOURCE",
           "MAX_MATERIALS"]

SOURCE = CSRC / "bounce_fused.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# the loop backward keeps one [M, 12] f32 table per warp in a block's shared
# memory (at most 227 KB on Hopper): up to 8 warps a block, fewer for large M
_SMEM_BYTES = 232448
_TABLE_BYTES_PER_MATERIAL = 4 * len(ETA_FIELDS)
MAX_MATERIALS = _SMEM_BYTES // _TABLE_BYTES_PER_MATERIAL


class BouncePreKernel:
    """Wrapper of ``bounce_pre_kernel``: see
    :func:`~hermespy_rt_tpu_torch.ops.bounce_fused.bounce_pre_plain`."""

    _ARGTYPES = (_P,) * 9 + (_I, _I, _I, _F) + (_P,) * 14

    def __init__(self):
        self.launches = 0
        self._fn = None

    def __call__(self, spec: FusedSpec, o, d, st, act, idx, table, material,
                 rx_pos, sc) -> PreOut:
        if o.device.type == "cpu":
            return bounce_pre_plain(spec, o, d, st, act, idx, table,
                                    material, rx_pos, sc)
        dev = cuda_device("bounce_pre", o)
        chk = OperandChecker("bounce_pre", dev)
        R, nrx, T = o.shape[0], spec.nrx, table.shape[0]
        ptrs = [chk("o", o, _F32, (R, 3)), chk("d", d, _F32, (R, 3)),
                chk("st", st, _F32, (6, R)), chk("act", act, _BOOL, (R,)),
                chk("idx", idx, _I32, (R,)),
                chk("table", table, _F32, (T, TABLE_COLS)),
                chk("material", material, _I32, (T,)),
                chk("rx_pos", rx_pos, _F32, (nrx, 3)),
                chk("sc", sc, _F32, (2,))]
        f32 = dict(dtype=_F32, device=dev)
        out = PreOut(
            o2=torch.empty((R, 3), **f32), d2=torch.empty((R, 3), **f32),
            st2=torch.empty((6, R), **f32), ex=torch.empty((3, R), **f32),
            sh_o=torch.empty((nrx, R, 3), **f32),
            sh_d=torch.empty((nrx, R, 3), **f32),
            d2rx=torch.empty((nrx, R), **f32),
            t_self=torch.empty((nrx, R), **f32),
            crossing=torch.empty((nrx, R), dtype=_BOOL, device=dev),
            excl=torch.empty((R,), dtype=_I32, device=dev),
            live=torch.empty((R,), dtype=_BOOL, device=dev),
            mat=torch.empty((R,), dtype=_I32, device=dev),
            res=torch.empty((3, R), **f32))
        if R == 0:
            return out
        if self._fn is None:
            self._fn = LIBRARY.function("hrt_bounce_pre", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = self._fn(*ptrs, R, nrx, int(spec.parity == "physical"),
                           spec.eps_o, *(x.data_ptr() for x in out),
                           torch.cuda.current_stream(dev).cuda_stream)
        raise_on("bounce_pre", err)
        self.launches += 1
        return out


class BouncePostKernel:
    """Wrapper of ``bounce_post_kernel``: see
    :func:`~hermespy_rt_tpu_torch.ops.bounce_fused.bounce_post_plain`."""

    _ARGTYPES = (_P,) * 13 + (_I, _I, _I, _F) + (_P,) * 4

    def __init__(self):
        self.launches = 0
        self._fn = None

    def __call__(self, spec: FusedSpec, d2, st2, ex, sh_d, d2rx, t_self,
                 crossing, excl, live, t_o, idx_o, table, sc) -> PostOut:
        if d2.device.type == "cpu":
            return bounce_post_plain(spec, d2, st2, ex, sh_d, d2rx, t_self,
                                     crossing, excl, live, t_o, idx_o, table,
                                     sc)
        dev = cuda_device("bounce_post", d2)
        chk = OperandChecker("bounce_post", dev)
        R, nrx, T = d2.shape[0], spec.nrx, table.shape[0]
        ptrs = [chk("d2", d2, _F32, (R, 3)), chk("st2", st2, _F32, (6, R)),
                chk("ex", ex, _F32, (3, R)),
                chk("sh_d", sh_d, _F32, (nrx, R, 3)),
                chk("d2rx", d2rx, _F32, (nrx, R)),
                chk("t_self", t_self, _F32, (nrx, R)),
                chk("crossing", crossing, _BOOL, (nrx, R)),
                chk("excl", excl, _I32, (R,)), chk("live", live, _BOOL, (R,)),
                chk("t_o", t_o, _F32, (nrx, R)),
                chk("idx_o", idx_o, _I32, (nrx, R)),
                chk("table", table, _F32, (T, TABLE_COLS)),
                chk("sc", sc, _F32, (2,))]
        out = PostOut(
            out=torch.empty((nrx, 6, R), dtype=_F32, device=dev),
            write=torch.empty((nrx, R), dtype=_BOOL, device=dev),
            res=torch.empty((nrx, 6, R), dtype=_F32, device=dev))
        if R == 0:
            return out
        if self._fn is None:
            self._fn = LIBRARY.function("hrt_bounce_post", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = self._fn(*ptrs, R, nrx, int(spec.parity == "physical"),
                           spec.eps_o, *(x.data_ptr() for x in out),
                           torch.cuda.current_stream(dev).cuda_stream)
        raise_on("bounce_post", err)
        self.launches += 1
        return out


class LoopBwdSlimKernel:
    """Wrapper of ``loop_bwd_slim_kernel``: see
    :func:`~hermespy_rt_tpu_torch.ops.bounce_fused.loop_bwd_slim_plain`.
    The kernel leaves one partial ``[M, 12]`` table per block; this wrapper
    sums them over the block axis, in a fixed order, so the result is the
    same from run to run."""

    _ARGTYPES = (_P, _I) + (_P,) * 6 + (_I, _I, _I, _P, _P, _I, _I, _P)

    def __init__(self):
        self.launches = 0
        self._fn = None

    def __call__(self, spec: FusedSpec, eta_tab, st_all, live_all, mat_all,
                 res_pre, res_post, d_out) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        if eta_tab.device.type == "cpu":
            return loop_bwd_slim_plain(spec, eta_tab, st_all, live_all,
                                       mat_all, res_pre, res_post, d_out)
        dev = cuda_device("loop_bwd_slim", eta_tab)
        chk = OperandChecker("loop_bwd_slim", dev)
        M, nrx = eta_tab.shape[0], spec.nrx
        B, R = st_all.shape[0] - 1, st_all.shape[-1]
        if M > MAX_MATERIALS:
            raise ValueError(f"loop_bwd_slim: {M} materials; its shared-"
                             f"memory table holds at most {MAX_MATERIALS}")
        ptrs = [chk("eta_tab", eta_tab, _F32, (M, len(ETA_FIELDS))),
                chk("st_all", st_all, _F32, (B + 1, 6, R)),
                chk("live_all", live_all, _BOOL, (B, R)),
                chk("mat_all", mat_all, _I32, (B, R)),
                chk("res_pre", res_pre, _F32, (B, 3, R)),
                chk("res_post", res_post, _F32, (B, nrx, 6, R)),
                chk("d_out", d_out, _F32, (B, nrx, 6, R))]
        d_st0 = torch.empty((6, R), dtype=_F32, device=dev)
        # a grid of a few waves of blocks, each walking its share of the
        # rays, keeps the partial tables few
        threads = 32 * min(8, _SMEM_BYTES // (max(M, 1)
                                              * _TABLE_BYTES_PER_MATERIAL))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n_blocks = max(1, min(-(-R // threads), 8 * sms))
        part = torch.empty((n_blocks, M, len(ETA_FIELDS)), dtype=_F32,
                           device=dev)
        if R == 0 or B == 0:
            return d_st0.zero_(), torch.zeros_like(eta_tab)
        if self._fn is None:
            self._fn = LIBRARY.function("hrt_loop_bwd_slim", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = self._fn(ptrs[0], M, *ptrs[1:], R, B, nrx, d_st0.data_ptr(),
                           part.data_ptr(), n_blocks, threads,
                           torch.cuda.current_stream(dev).cuda_stream)
        raise_on("loop_bwd_slim", err)
        self.launches += 1
        return d_st0, part.sum(dim=0)


bounce_pre = BouncePreKernel()
bounce_post = BouncePostKernel()
loop_bwd_slim = LoopBwdSlimKernel()
