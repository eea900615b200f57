"""Launch wrapper of the table scatter-add kernel (``csrc/scatter_add.cu``),
which replaces ``hermespy_rt_tpu/ops/fetch_pallas.py::_bwd_kernel``
(``pallas_scatter_add``): ``dtable[k] = sum over r with idx[r] == k of
g[r]``.

:data:`scatter_add` takes the arguments of
:func:`~hermespy_rt_tpu_torch.ops.fetch.scatter_add_plain` and, optionally,
a ``[T, W]`` table ``out`` to add the sums into at column ``col``.  Given
CPU tensors it runs the plain version; given CUDA tensors it sorts the ids
(``torch.sort``, stable, as the walk's visit rows), launches the kernel on
the current stream and raises on a nonzero ``cudaError``.  The sums are
taken in ray order, so they come out the same in every run.  Its
``launches`` count goes up by one per launch and nowhere else.

:func:`gather_rows` is a row fetch ``table[idx]`` whose backward is
:data:`scatter_add`.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda_build import (CSRC, LIBRARY, OperandChecker, cuda_device,
                          raise_on)
from .fetch import scatter_add_plain

__all__ = ["scatter_add", "gather_rows", "SOURCE", "CHUNK"]

SOURCE = CSRC / "scatter_add.cu"
CHUNK = 128         # sorted rows per chunk of each level of the kernel
_P, _I = ctypes.c_void_p, ctypes.c_int


class ScatterAddKernel:
    """Wrapper of ``scatter_add_kernel`` (one launch per level in one call:
    the sorted rows in chunks, then the chunks' boundary entries, until one
    chunk is left)."""

    _ARGTYPES = (_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P)

    def __init__(self):
        self.launches = 0
        self._fn = None

    def __call__(self, idx, g, T: int, out=None, col: int = 0):
        N, C = g.shape
        if out is None:
            out = g.new_zeros((T, C))
        if tuple(out.shape[:1]) != (T,) or not 0 <= col <= out.shape[1] - C:
            raise ValueError(f"scatter_add: out {tuple(out.shape)} cannot "
                             f"take {C} columns at {col} of {T} rows")
        if g.device.type == "cpu":
            out[:, col:col + C] += scatter_add_plain(idx, g, T)
            return out
        dev = cuda_device("scatter_add", g)
        chk = OperandChecker("scatter_add", dev)
        chk("idx", idx, torch.int32, (N,))
        chk("g", g, torch.float32, (N, C))
        chk("out", out, torch.float32, tuple(out.shape))
        if N == 0 or C == 0:
            return out
        keys, perm = torch.sort(idx, stable=True)
        half = 2 * -(-N // CHUNK)      # boundary entries of the first level
        scratch_g = torch.empty((2, half, C), dtype=torch.float32, device=dev)
        scratch_keys = torch.empty((2, half), dtype=torch.int32, device=dev)
        if self._fn is None:
            self._fn = LIBRARY.function("hrt_scatter_add", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = self._fn(keys.data_ptr(), perm.data_ptr(), g.data_ptr(), N,
                           C, CHUNK, out.data_ptr(), T, out.shape[1], col,
                           scratch_g.data_ptr(), scratch_keys.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
        raise_on("scatter_add", err)
        self.launches += 1
        return out


scatter_add = ScatterAddKernel()


class _RowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return scatter_add(idx, g.contiguous(), ctx.rows), None


def gather_rows(table, idx):
    """``table[idx]`` for ``table`` f32[T, C] and ``idx`` i32[N] in
    ``[0, T)``; its backward sums the rows' cotangents per table row with
    :data:`scatter_add` (the same bits in every run), where PyTorch's
    indexing backward serialises the many rows of one index."""
    return _RowGather.apply(table, idx)
