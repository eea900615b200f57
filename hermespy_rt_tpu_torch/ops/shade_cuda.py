"""Launch wrapper of the reflection-half shading kernel (``csrc/shade.cu``),
which replaces ``hermespy_rt_tpu/ops/shade.py::_shade_a_kernel``, and its
autograd node.

:data:`shade_a` takes the arguments of
:func:`~hermespy_rt_tpu_torch.ops.shade.shade_a_plain`.  Given CPU tensors
it runs that plain version; given CUDA tensors it checks device, type, shape
and contiguity, launches the kernel on the current stream and raises on a
nonzero ``cudaError``.  Its ``launches`` count goes up by one per launch and
nowhere else.

:class:`ShadeAFn` is the op path's ``shade="pallas"`` shading: the forward
is :data:`shade_a`; the backward is ``torch.func.vjp`` of the plain
version at the saved inputs, as the JAX package's ``_shade_a_bwd`` takes
``jax.vjp`` of ``shade_a_jnp``.  :func:`shade_a_rows` calls it with the op
path's operands.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import LaunchCounter
from ._cuda_build import (CSRC, LIBRARY, OperandChecker, cuda_device,
                          raise_on)
from .bounce_fused import TABLE_COLS
from .shade import GEOM_COLS, shade_a_plain

__all__ = ["shade_a", "ShadeAFn", "shade_a_rows", "SOURCE"]

SOURCE = CSRC / "shade.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_F32 = torch.float32


class ShadeAKernel(LaunchCounter):
    """Wrapper of ``shade_a_kernel`` (one per process)."""

    _ARGTYPES = (_P,) * 6 + (_I,) + (_P,) * 5

    def __init__(self):
        super().__init__("shade_a")
        self._fn = None

    def __call__(self, o, d, st, live, row, sc):
        if o.device.type == "cpu":
            return shade_a_plain(o, d, st, live, row, sc)
        dev = cuda_device("shade_a", o)
        R = o.shape[0]
        chk = OperandChecker("shade_a", dev)
        ptrs = [chk("o", o, _F32, (R, 3)), chk("d", d, _F32, (R, 3)),
                chk("st", st, _F32, (6, R)),
                chk("live", live, torch.bool, (R,)),
                chk("row", row, _F32, (R, TABLE_COLS)),
                chk("sc", sc, _F32, (2,))]
        f32 = dict(dtype=_F32, device=dev)
        out = (torch.empty((R, 3), **f32), torch.empty((R, 3), **f32),
               torch.empty((6, R), **f32), torch.empty((5, R), **f32))
        if R == 0:
            return out
        if self._fn is None:
            self._fn = LIBRARY.function("hrt_shade_a", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = self._fn(*ptrs, R, *(x.data_ptr() for x in out),
                           torch.cuda.current_stream(dev).cuda_stream)
        raise_on("shade_a", err)
        self.launched()
        return out


shade_a = ShadeAKernel()


class ShadeAFn(torch.autograd.Function):
    """The reflection half as an autograd node: forward
    :data:`shade_a`, backward ``torch.func.vjp`` of
    :func:`shade_a_plain` at the saved inputs.  With ``grad_geometry``
    False the payload's 15 geometry columns are constants of the backward
    and get no cotangent (the eta columns do)."""

    @staticmethod
    def forward(ctx, o, d, st, live, row, sc, grad_geometry):
        ctx.grad_geometry = grad_geometry
        ctx.save_for_backward(o, d, st, live, row, sc)
        return shade_a(o, d, st, live, row, sc)

    @staticmethod
    def backward(ctx, d_o2, d_d2, d_st2, d_ex):
        o, d, st, live, row, sc = ctx.saved_tensors
        if ctx.grad_geometry:
            def fn(o_, d_, st_, row_, sc_):
                return shade_a_plain(o_, d_, st_, live, row_, sc_)
            primals = (o, d, st, row, sc)
        else:
            geo = row[:, :GEOM_COLS]

            def fn(o_, d_, st_, eta_, sc_):
                return shade_a_plain(o_, d_, st_, live,
                                     torch.cat([geo, eta_], dim=1), sc_)
            primals = (o, d, st, row[:, GEOM_COLS:], sc)
        _, vjp = torch.func.vjp(fn, *primals)
        d_o, d_d, d_st, d_row, d_sc = vjp((d_o2, d_d2, d_st2, d_ex))
        if not ctx.grad_geometry:
            d_row = torch.cat([d_row.new_zeros((d_row.shape[0], GEOM_COLS)),
                               d_row], dim=1)
        return d_o, d_d, d_st, None, d_row, d_sc, None


def shade_a_rows(o, d, ate_re, ate_im, atm_re, atm_im, tau, freq, live, row,
                 fslm, k_dop, grad_geometry=True):
    """:func:`~hermespy_rt_tpu_torch.ops.shade.shade_a`'s outputs through
    :class:`ShadeAFn`, from the fetched payload rows ``row`` [R, 27]."""
    st = torch.stack([ate_re, ate_im, atm_re, atm_im, tau, freq])
    sc = torch.stack([torch.as_tensor(fslm), torch.as_tensor(k_dop)]).to(o)
    o2, d2, st2, ex = ShadeAFn.apply(o.contiguous(), d.contiguous(), st,
                                     live.contiguous(), row.contiguous(), sc,
                                     grad_geometry)
    return (o2, d2, *st2.unbind(0), *ex.unbind(0))
