"""Launch wrappers of the fused bounce kernels (``csrc/bounce_fused.cu``,
``csrc/bounce_bwd.cu``) and the two stages as autograd nodes.

* :data:`bounce_pre` replaces ``hermespy_rt_tpu/ops/bounce_fused.py::
  _pre_fwd_kernel``;
* :data:`bounce_post` replaces ``::_post_fwd_kernel``;
* :data:`loop_bwd_slim` replaces ``::_loop_bwd_slim_kernel``;
* :data:`bounce_pre_bwd` replaces ``::_pre_bwd_kernel``;
* :data:`bounce_post_bwd` replaces ``::_post_bwd_kernel``;
* :data:`bounce_pre_bwd_slim` replaces ``::_pre_bwd_slim_kernel``;
* :data:`bounce_post_bwd_slim` replaces ``::_post_bwd_slim_kernel``.

Each takes the arguments of its plain version in :mod:`.bounce_fused`.
:data:`bounce_pre` and :data:`bounce_post` run the transmission modes that
``spec`` sets (the forward alone: no backward kernel takes them), under
``spawn_transmission`` on each ray's pattern word ``pat`` at bounce ``k``.
Given CPU tensors it runs that plain version; given CUDA tensors it checks
device, type, shape and contiguity, allocates the outputs, launches the
kernel on the current stream and raises on a nonzero ``cudaError``.  Its
``launches`` count goes up by one per kernel launch and nowhere else.

:class:`BouncePreFn` and :class:`BouncePostFn` are the two stages as
``torch.autograd.Function`` s, the counterparts of JAX's ``bounce_pre`` /
``bounce_post`` custom_vjps: the forward kernels, then the full backwards
(``spec.grad_positions``) or the slim ones, whose per-ray payload rows the
table scatter-add (:data:`.fetch_cuda.scatter_add`) sums into the table's
cotangent.  Sums across rays come out the same in every run: the backwards
leave per-block partials of the RX-position and carrier-scalar cotangents
and of the material table, summed in a fixed order here (the full pre and
the whole-loop backwards) or by the kernel's last block (the full post
backward), and the scatter-add sums in ray order.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import fetch_cuda
from ..utils.profiling import (LaunchCounter, current_call,
                               traced_backward)
from ._cuda_build import (CSRC, LIBRARY, OperandChecker, cuda_device,
                          raise_on)
from .bounce_fused import (NORMAL_COL, TABLE_COLS, FusedSpec, PostOut, PreOut,
                           bounce_post_bwd_plain, bounce_post_bwd_slim_plain,
                           bounce_post_plain, bounce_pre_bwd_plain,
                           bounce_pre_bwd_slim_plain, bounce_pre_plain,
                           loop_bwd_slim_plain, payload_cols)
from .fresnel import ETA_FIELDS

__all__ = ["bounce_pre", "bounce_post", "loop_bwd_slim", "bounce_pre_bwd",
           "bounce_post_bwd", "bounce_pre_bwd_slim", "bounce_post_bwd_slim",
           "BouncePreFn", "BouncePostFn", "bounce_pre_stage",
           "bounce_post_stage", "SOURCE", "BWD_SOURCE", "MAX_MATERIALS",
           "PRE_BWD_MAX_RX", "FWD_MAX_RAYS", "forward_takes"]

SOURCE = CSRC / "bounce_fused.cu"
BWD_SOURCE = CSRC / "bounce_bwd.cu"
_PRE_BWD_RAYS = 128                 # rays a block of the full backwards
_POST_BWD_RAYS = 128
PRE_BWD_MAX_RX = 340                # its 3 nrx + 2 sums in shared memory
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# the loop backward keeps one [M, 12] f32 table per warp in a block's shared
# memory (at most 227 KB on Hopper): up to 8 warps a block, fewer for large M
_SMEM_BYTES = 232448
_TABLE_BYTES_PER_MATERIAL = 4 * len(ETA_FIELDS)
MAX_MATERIALS = _SMEM_BYTES // _TABLE_BYTES_PER_MATERIAL
# the forward kernels take R as a C int and index a ray's xyz as 3 r + c
FWD_MAX_RAYS = (2 ** 31 - 1) // 3


def _modes(spec: FusedSpec) -> int:
    """The forward kernels' ``trans`` argument: bit 0 ``transmission``,
    bit 1 ``spawn_transmission``."""
    return int(spec.transmission) | 2 * int(spec.spawn_transmission)


def _pattern(chk, spec: FusedSpec, pat, R):
    """The pattern words' pointer under ``spawn_transmission``, else
    None (the kernel reads none)."""
    if not spec.spawn_transmission:
        return None
    return chk("pat", pat, _I32, (R,))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def forward_takes(rays: int, nrx: int) -> bool:
    """Whether :data:`bounce_pre` and :data:`bounce_post` take ``rays`` rays
    and ``nrx`` RX: at least one RX (:class:`.bounce_fused.FusedSpec`) and
    at most :data:`FWD_MAX_RAYS` rays."""
    return nrx >= 1 and rays <= FWD_MAX_RAYS


class BouncePreKernel(LaunchCounter):
    """Wrapper of ``bounce_pre_kernel``: see
    :func:`~hermespy_rt_tpu_torch.ops.bounce_fused.bounce_pre_plain`."""

    _ARGTYPES = (_P,) * 9 + (_I, _I, _I, _F) + (_P,) * 14 + (_I, _I, _P)

    def __init__(self):
        super().__init__("bounce_pre")
        self._fn = None

    def __call__(self, spec: FusedSpec, o, d, st, act, idx, table, material,
                 rx_pos, sc, pat=None, k=0) -> PreOut:
        if o.device.type == "cpu":
            return bounce_pre_plain(spec, o, d, st, act, idx, table,
                                    material, rx_pos, sc, pat, k)
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
        pat_ptr = _pattern(chk, spec, pat, R)
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
                           spec.eps_o, *(x.data_ptr() for x in out), pat_ptr,
                           k, _modes(spec), _stream(dev))
        raise_on("bounce_pre", err)
        self.launched()
        return out


class BouncePostKernel(LaunchCounter):
    """Wrapper of ``bounce_post_kernel``: see
    :func:`~hermespy_rt_tpu_torch.ops.bounce_fused.bounce_post_plain`."""

    _ARGTYPES = (_P,) * 13 + (_I, _I, _I, _F) + (_P,) * 4 + (_I, _I, _P)

    def __init__(self):
        super().__init__("bounce_post")
        self._fn = None

    def __call__(self, spec: FusedSpec, d2, st2, ex, sh_d, d2rx, t_self,
                 crossing, excl, live, t_o, idx_o, table, sc, pat=None,
                 k=0) -> PostOut:
        if d2.device.type == "cpu":
            return bounce_post_plain(spec, d2, st2, ex, sh_d, d2rx, t_self,
                                     crossing, excl, live, t_o, idx_o, table,
                                     sc, pat, k)
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
        pat_ptr = _pattern(chk, spec, pat, R)
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
                           spec.eps_o, *(x.data_ptr() for x in out), pat_ptr,
                           k, _modes(spec), _stream(dev))
        raise_on("bounce_post", err)
        self.launched()
        return out


def loop_bwd_threads(M: int) -> int:
    """Threads a block of the whole-loop backward: 8 warps, fewer where
    their ``[M, 12]`` tables do not fit a block's shared memory."""
    return 32 * min(8, _SMEM_BYTES // (max(M, 1) * _TABLE_BYTES_PER_MATERIAL))


def loop_bwd_blocks(R: int, threads: int, sms: int) -> int:
    """Blocks of the whole-loop backward: a few waves of blocks (8 an SM),
    each walking its share of the rays; the card deals them out as they
    finish (the work per ray varies: one wave was slower), and their
    partial tables stay few.  Fewer where the rays do not fill them."""
    return max(1, min(-(-R // threads), 8 * sms))


class LoopBwdSlimKernel(LaunchCounter):
    """Wrapper of ``loop_bwd_slim_kernel``: see
    :func:`~hermespy_rt_tpu_torch.ops.bounce_fused.loop_bwd_slim_plain`.
    The kernel leaves one partial ``[M, 12]`` table per block; this wrapper
    sums them over the block axis, in a fixed order, so the result is the
    same from run to run."""

    _ARGTYPES = (_P, _I) + (_P,) * 6 + (_I, _I, _I, _P, _P, _I, _I, _P)

    def __init__(self):
        super().__init__("loop_bwd_slim")
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
        threads = loop_bwd_threads(M)
        n_blocks = loop_bwd_blocks(
            R, threads,
            torch.cuda.get_device_properties(dev).multi_processor_count)
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
        self.launched()
        return d_st0, part.sum(dim=0)


class BouncePreBwdKernel(LaunchCounter):
    """Wrapper of ``bounce_pre_bwd_kernel``: see
    :func:`~hermespy_rt_tpu_torch.ops.bounce_fused.bounce_pre_bwd_plain`.
    The kernel leaves per-block partials of ``d_rxp`` and ``d_sc``, summed
    here over the block axis in a fixed order."""

    _ARGTYPES = (_P,) * 14 + (_I, _I, _I) + (_P,) * 5 + (_P,)

    def __init__(self):
        super().__init__("bounce_pre_bwd")
        self._fn = None

    def __call__(self, spec: FusedSpec, o, d, st, act, idx, table, rx_pos,
                 sc, d_o2, d_d2, d_st2, d_ex, d_sh_d, d_d2rx):
        if o.device.type == "cpu":
            return bounce_pre_bwd_plain(spec, o, d, st, act, idx, table,
                                        rx_pos, sc, d_o2, d_d2, d_st2, d_ex,
                                        d_sh_d, d_d2rx)
        if not spec.grad_positions:
            raise ValueError("bounce_pre_bwd: the full backward needs "
                             "spec.grad_positions")
        dev = cuda_device("bounce_pre_bwd", o)
        chk = OperandChecker("bounce_pre_bwd", dev)
        R, nrx, T = o.shape[0], spec.nrx, table.shape[0]
        if nrx > PRE_BWD_MAX_RX:
            raise ValueError(f"bounce_pre_bwd: the kernel takes at most "
                             f"{PRE_BWD_MAX_RX} RX, not {nrx}")
        ptrs = [chk("o", o, _F32, (R, 3)), chk("d", d, _F32, (R, 3)),
                chk("st", st, _F32, (6, R)), chk("act", act, _BOOL, (R,)),
                chk("idx", idx, _I32, (R,)),
                chk("table", table, _F32, (T, TABLE_COLS)),
                chk("rx_pos", rx_pos, _F32, (nrx, 3)),
                chk("sc", sc, _F32, (2,)),
                chk("d_o2", d_o2, _F32, (R, 3)),
                chk("d_d2", d_d2, _F32, (R, 3)),
                chk("d_st2", d_st2, _F32, (6, R)),
                chk("d_ex", d_ex, _F32, (3, R)),
                chk("d_sh_d", d_sh_d, _F32, (nrx, R, 3)),
                chk("d_d2rx", d_d2rx, _F32, (nrx, R))]
        pc = payload_cols(spec, "pre")
        f32 = dict(dtype=_F32, device=dev)
        n_blocks = max(1, -(-R // _PRE_BWD_RAYS))
        outs = (torch.empty((R, 3), **f32), torch.empty((R, 3), **f32),
                torch.empty((6, R), **f32), torch.empty((R, pc), **f32),
                (torch.empty if R > 0 else torch.zeros)(
                    (n_blocks, 3 * nrx + 2), **f32))
        if R > 0:
            if self._fn is None:
                self._fn = LIBRARY.function("hrt_bounce_pre_bwd",
                                            self._ARGTYPES)
            with torch.cuda.device(dev):
                err = self._fn(*ptrs, R, nrx, pc,
                               *(x.data_ptr() for x in outs), _stream(dev))
            raise_on("bounce_pre_bwd", err)
            self.launched()
        d_o, d_d, d_st, d_payload, part = outs
        tot = part.sum(dim=0)
        return (d_o, d_d, d_st, d_payload, tot[:3 * nrx].reshape(nrx, 3),
                tot[3 * nrx:])


class BouncePostBwdKernel(LaunchCounter):
    """Wrapper of ``bounce_post_bwd_kernel``: see
    :func:`~hermespy_rt_tpu_torch.ops.bounce_fused.bounce_post_bwd_plain`.
    The kernel leaves per-block partials of ``d_sc`` in scratch, and its
    last block sums them in a fixed order."""

    _ARGTYPES = (_P,) * 14 + (_I, _I, _I, _F, _I) + (_P,) * 10 + (_P,)

    def __init__(self):
        super().__init__("bounce_post_bwd")
        self._fn = None

    def __call__(self, spec: FusedSpec, d2, st2, ex, sh_d, d2rx, t_self,
                 crossing, excl, live, t_o, idx_o, table, sc, d_out):
        if d2.device.type == "cpu":
            return bounce_post_bwd_plain(spec, d2, st2, ex, sh_d, d2rx,
                                         t_self, crossing, excl, live, t_o,
                                         idx_o, table, sc, d_out)
        if not spec.grad_positions:
            raise ValueError("bounce_post_bwd: the full backward needs "
                             "spec.grad_positions")
        dev = cuda_device("bounce_post_bwd", d2)
        chk = OperandChecker("bounce_post_bwd", dev)
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
                chk("sc", sc, _F32, (2,)),
                chk("d_out", d_out, _F32, (nrx, 6, R))]
        pc = payload_cols(spec, "post")
        normals = spec.grad_geometry and spec.parity == "reference"
        f32 = dict(dtype=_F32, device=dev)
        outs = [torch.empty((R, 3), **f32), torch.empty((6, R), **f32),
                torch.empty((3, R), **f32), torch.empty((nrx, R, 3), **f32),
                torch.empty((nrx, R), **f32), torch.empty((R, pc), **f32),
                torch.empty((nrx, R, 3), **f32) if normals else None,
                (torch.empty((nrx, R), dtype=_I32, device=dev) if normals
                 else None),
                (torch.empty if R > 0 else torch.zeros)(2, **f32)]
        if R > 0:
            part = torch.empty((-(-R // _POST_BWD_RAYS), 2), **f32)
            if self._fn is None:
                self._fn = LIBRARY.function("hrt_bounce_post_bwd",
                                            self._ARGTYPES)
            with torch.cuda.device(dev):
                err = self._fn(*ptrs, R, nrx, int(spec.parity == "physical"),
                               spec.eps_o, pc,
                               *(None if x is None else x.data_ptr()
                                 for x in outs[:-1]), part.data_ptr(),
                               outs[-1].data_ptr(), _stream(dev))
            raise_on("bounce_post_bwd", err)
            self.launched()
        return tuple(outs)


class BouncePreBwdSlimKernel(LaunchCounter):
    """Wrapper of ``bounce_pre_bwd_slim_kernel``: see
    :func:`.bounce_fused.bounce_pre_bwd_slim_plain`."""

    _ARGTYPES = (_P,) * 6 + (_I,) + (_P,) * 2 + (_P,)

    def __init__(self):
        super().__init__("bounce_pre_bwd_slim")
        self._fn = None

    def __call__(self, spec: FusedSpec, st, act, idx, table, res, d_st2):
        if st.device.type == "cpu":
            return bounce_pre_bwd_slim_plain(spec, st, act, idx, table, res,
                                             d_st2)
        dev = cuda_device("bounce_pre_bwd_slim", st)
        chk = OperandChecker("bounce_pre_bwd_slim", dev)
        R, T = st.shape[-1], table.shape[0]
        ptrs = [chk("st", st, _F32, (6, R)), chk("act", act, _BOOL, (R,)),
                chk("idx", idx, _I32, (R,)),
                chk("table", table, _F32, (T, TABLE_COLS)),
                chk("res", res, _F32, (3, R)),
                chk("d_st2", d_st2, _F32, (6, R))]
        outs = (torch.empty((6, R), dtype=_F32, device=dev),
                torch.empty((R, len(ETA_FIELDS)), dtype=_F32, device=dev))
        if R > 0:
            if self._fn is None:
                self._fn = LIBRARY.function("hrt_bounce_pre_bwd_slim",
                                            self._ARGTYPES)
            with torch.cuda.device(dev):
                err = self._fn(*ptrs, R, *(x.data_ptr() for x in outs),
                               _stream(dev))
            raise_on("bounce_pre_bwd_slim", err)
            self.launched()
        return outs


class BouncePostBwdSlimKernel(LaunchCounter):
    """Wrapper of ``bounce_post_bwd_slim_kernel``: see
    :func:`.bounce_fused.bounce_post_bwd_slim_plain`."""

    _ARGTYPES = (_P,) * 5 + (_I, _I) + (_P,) * 2 + (_P,)

    def __init__(self):
        super().__init__("bounce_post_bwd_slim")
        self._fn = None

    def __call__(self, spec: FusedSpec, st2, excl, table, res, d_out):
        if st2.device.type == "cpu":
            return bounce_post_bwd_slim_plain(spec, st2, excl, table, res,
                                              d_out)
        dev = cuda_device("bounce_post_bwd_slim", st2)
        chk = OperandChecker("bounce_post_bwd_slim", dev)
        R, nrx, T = st2.shape[-1], spec.nrx, table.shape[0]
        ptrs = [chk("st2", st2, _F32, (6, R)), chk("excl", excl, _I32, (R,)),
                chk("table", table, _F32, (T, TABLE_COLS)),
                chk("res", res, _F32, (nrx, 6, R)),
                chk("d_out", d_out, _F32, (nrx, 6, R))]
        outs = (torch.empty((6, R), dtype=_F32, device=dev),
                torch.empty((R, 2), dtype=_F32, device=dev))
        if R > 0:
            if self._fn is None:
                self._fn = LIBRARY.function("hrt_bounce_post_bwd_slim",
                                            self._ARGTYPES)
            with torch.cuda.device(dev):
                err = self._fn(*ptrs, R, nrx, *(x.data_ptr() for x in outs),
                               _stream(dev))
            raise_on("bounce_post_bwd_slim", err)
            self.launched()
        return outs


bounce_pre = BouncePreKernel()
bounce_post = BouncePostKernel()
loop_bwd_slim = LoopBwdSlimKernel()
bounce_pre_bwd = BouncePreBwdKernel()
bounce_post_bwd = BouncePostBwdKernel()
bounce_pre_bwd_slim = BouncePreBwdSlimKernel()
bounce_post_bwd_slim = BouncePostBwdSlimKernel()


# ---------------------------------------------------------------------------
# the two stages as autograd nodes (module-level names are looked up at each
# call, so a recorder that stands in for a wrapper sees these calls too)

def _table_cotangent(table, rows, excl):
    """The ``[T, 27]`` table cotangent of per-ray payload rows ``rows``
    [R, C] (the last C table columns) at the rows ``excl``."""
    d_table = torch.zeros_like(table)
    return fetch_cuda.scatter_add(excl, rows, table.shape[0], out=d_table,
                                  col=TABLE_COLS - rows.shape[1])


class BouncePreFn(torch.autograd.Function):
    """The pre stage as an autograd node: :data:`bounce_pre` forward;
    backward :data:`bounce_pre_bwd` (``spec.grad_positions``: cotangents of
    ``o, d, st, table, rx_pos, sc``) or :data:`bounce_pre_bwd_slim`
    (``st`` and the table's eta columns), then the table scatter-add at the
    live rays' hits.  Its outputs are :class:`PreOut`'s fields; the
    shadow-query origins, decisions and residuals carry no gradient."""

    @staticmethod
    def forward(ctx, spec, o, d, st, act, idx, table, material, rx_pos, sc):
        out = bounce_pre(spec, o, d, st, act, idx, table, material, rx_pos,
                         sc)
        ctx.spec, ctx.call = spec, current_call()
        ctx.save_for_backward(o, d, st, act, idx, table, rx_pos, sc, out.res,
                              out.excl)
        ctx.mark_non_differentiable(out.sh_o, out.t_self, out.crossing,
                                    out.excl, out.live, out.mat, out.res)
        return tuple(out)

    @staticmethod
    @traced_backward
    def backward(ctx, d_o2, d_d2, d_st2, d_ex, _d_sh_o, d_sh_d, d_d2rx, *_):
        spec = ctx.spec
        o, d, st, act, idx, table, rx_pos, sc, res, excl = ctx.saved_tensors
        d_o = d_d = d_rxp = d_sc = None
        if spec.grad_positions:
            d_o, d_d, d_st, d_pay, d_rxp, d_sc = bounce_pre_bwd(
                spec, o, d, st, act, idx, table, rx_pos, sc,
                *(x.contiguous() for x in (d_o2, d_d2, d_st2, d_ex, d_sh_d,
                                           d_d2rx)))
        else:
            d_st, d_pay = bounce_pre_bwd_slim(spec, st, act, idx, table, res,
                                              d_st2.contiguous())
        d_table = (_table_cotangent(table, d_pay, excl)
                   if ctx.needs_input_grad[6] else None)
        return (None, d_o, d_d, d_st, None, None, d_table, None, d_rxp,
                d_sc)


class BouncePostFn(torch.autograd.Function):
    """The post stage as an autograd node: :data:`bounce_post` forward;
    backward :data:`bounce_post_bwd` (``spec.grad_positions``: cotangents
    of ``d2, st2, ex, sh_d, d2rx, table, sc``, the occluder normals'
    included) or :data:`bounce_post_bwd_slim` (``st2`` and the table's (s,
    s1_alpha) columns), then the table scatter-add.  Outputs ``(out,
    write, res)``; ``write`` and ``res`` carry no gradient."""

    @staticmethod
    def forward(ctx, spec, d2, st2, ex, sh_d, d2rx, t_self, crossing, excl,
                live, t_o, idx_o, table, sc):
        out = bounce_post(spec, d2, st2, ex, sh_d, d2rx, t_self, crossing,
                          excl, live, t_o, idx_o, table, sc)
        ctx.spec, ctx.call = spec, current_call()
        ctx.save_for_backward(d2, st2, ex, sh_d, d2rx, t_self, crossing,
                              excl, live, t_o, idx_o, table, sc, out.res)
        ctx.mark_non_differentiable(out.write, out.res)
        return tuple(out)

    @staticmethod
    @traced_backward
    def backward(ctx, d_out, *_):
        spec = ctx.spec
        (d2, st2, ex, sh_d, d2rx, t_self, crossing, excl, live, t_o, idx_o,
         table, sc, res) = ctx.saved_tensors
        d_d2 = d_ex = d_sh_d = d_d2rx = d_sc = d_n_o = None
        if spec.grad_positions:
            (d_d2, d_st2, d_ex, d_sh_d, d_d2rx, d_pay, d_n_o, occ,
             d_sc) = bounce_post_bwd(spec, d2, st2, ex, sh_d, d2rx, t_self,
                                     crossing, excl, live, t_o, idx_o, table,
                                     sc, d_out.contiguous())
        else:
            d_st2, d_pay = bounce_post_bwd_slim(spec, st2, excl, table, res,
                                                d_out.contiguous())
        d_table = None
        if ctx.needs_input_grad[12]:
            d_table = _table_cotangent(table, d_pay, excl)
            if d_n_o is not None:
                fetch_cuda.scatter_add(occ.reshape(-1), d_n_o.reshape(-1, 3),
                                       table.shape[0], out=d_table,
                                       col=NORMAL_COL)
        return (None, d_d2, d_st2, d_ex, d_sh_d, d_d2rx, None, None, None,
                None, None, None, d_table, d_sc)


def bounce_pre_stage(spec: FusedSpec, *args) -> PreOut:
    """:class:`BouncePreFn` on ``bounce_pre``'s arguments."""
    return PreOut(*BouncePreFn.apply(spec, *args))


def bounce_post_stage(spec: FusedSpec, *args) -> PostOut:
    """:class:`BouncePostFn` on ``bounce_post``'s arguments."""
    return PostOut(*BouncePostFn.apply(spec, *args))
