"""Launch wrappers of the row fetch (``csrc/gather.cu``, which replaces
``hermespy_rt_tpu/ops/fetch_pallas.py::_fwd_kernel``: ``table[idx]``) and
of the table scatter-add (``csrc/scatter_add.cu``, which replaces
``::_bwd_kernel``, ``pallas_scatter_add``: ``dtable[k] = sum over r with
idx[r] == k of g[r]``).

:data:`gather` takes the arguments of
:func:`~hermespy_rt_tpu_torch.ops.fetch.gather_plain`.  Given CPU tensors it
runs the plain version; given CUDA tensors it launches the kernel on the
current stream (:func:`~.fetch.gather_plan`: one warp per 32 output rows,
16-byte stores, a small table staged in shared memory) or raises.  Its
``launches`` count goes up by one per launch and nowhere else.

:data:`scatter_add` takes the arguments of
:func:`~hermespy_rt_tpu_torch.ops.fetch.scatter_add_plain` and, optionally,
a ``[T, W]`` table ``out`` to add the sums into at column ``col``; ``g`` may
be a column window of a wider tensor (rows of unit stride), read where it
lies.  Given CPU tensors it runs the plain version; given CUDA tensors it
takes one of two routes (:func:`~.fetch.scatter_route`, from (T, C) and the
shared memory the card allows a block) on the current stream and raises on
a nonzero ``cudaError``:

- *dense* (every table whose ``[T, C]`` f32 fits a warp's share of shared
  memory: the canyon's 256 rows, the material tables): two launches, no
  sort; the sums in the grouping of
  :func:`~.fetch.scatter_add_ordered_plain`, bit for bit;
- *sorted* (larger tables): the ids sorted stably (``torch.sort``), then one
  launch per level of chunks, the sums in ray order in chunks.

Either way the sums come out the same in every run.  Its ``launches`` count
goes up by one per call and nowhere else.

:func:`gather_rows` is a row fetch through :data:`gather` whose backward is
:data:`scatter_add`.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda_build import (CSRC, LIBRARY, OperandChecker, cuda_device,
                          raise_on)
from .fetch import (dense_plan, gather_plain, gather_plan, scatter_add_plain,
                    scatter_route)

__all__ = ["gather", "scatter_add", "gather_rows", "SOURCE", "GATHER_SOURCE",
           "CHUNK"]

SOURCE = CSRC / "scatter_add.cu"
GATHER_SOURCE = CSRC / "gather.cu"
CHUNK = 128         # sorted rows per chunk of each level of the sorted route
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


class GatherKernel:
    """Wrapper of ``gather_kernel``: one launch of :func:`.gather_plan`'s
    persistent grid."""

    _ARGTYPES = (_P, _I, _I, _I, _I, _P, _L, _I, _P, _I, _I, _P)

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._sm_count = {}

    def plan(self, N: int, T: int, C: int, dev):
        if dev not in self._sm_count:
            self._sm_count[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        return gather_plan(N, T, C, self._sm_count[dev])

    def __call__(self, table, idx, col: int = 0, width=None):
        T, W = table.shape
        width = W - col if width is None else width
        if not (0 <= col and width >= 0 and col + width <= W):
            raise ValueError(f"gather: columns {col} .. {col + width} of a "
                             f"{W}-column table")
        if table.device.type == "cpu":
            return gather_plain(table, idx, col, width)
        dev = cuda_device("gather", table)
        N = idx.shape[0]
        chk = OperandChecker("gather", dev)
        chk("table", table, torch.float32, (T, W))
        chk("idx", idx, torch.int32, (N,))
        out = torch.empty((N, width), dtype=torch.float32, device=dev)
        if N == 0 or width == 0:
            return out
        plan = self.plan(N, T, width, dev)
        if self._fn is None:
            self._fn = LIBRARY.function("hrt_gather", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = self._fn(table.data_ptr(), T, W, col, width, idx.data_ptr(),
                           plan.full_groups, plan.tail_rows, out.data_ptr(),
                           int(plan.staged), plan.blocks, _stream(dev))
        raise_on("gather", err)
        self.launches += 1
        return out


gather = GatherKernel()


class ScatterAddKernel:
    """Wrapper of ``scatter_add_kernel_partials`` and ``_sum`` (the dense
    route) and of ``scatter_add_kernel_sorted`` (the sorted route, one
    launch per level)."""

    _DENSE_ARGTYPES = (_P, _P, _L, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P)
    _SORTED_ARGTYPES = (_P, _P, _P, _L, _I, _I, _I, _P, _I, _I, _I, _P, _P,
                        _P)

    def __init__(self):
        self.launches = 0
        self._fns = {}
        self._smem_optin = {}

    def _fn(self, name, argtypes):
        if name not in self._fns:
            self._fns[name] = LIBRARY.function(name, argtypes)
        return self._fns[name]

    def route(self, T: int, C: int, dev) -> str:
        """:func:`.scatter_route` on the card of ``dev``."""
        if dev not in self._smem_optin:
            fn = self._fn("hrt_smem_optin", (_I, ctypes.POINTER(_I)))
            value = _I(0)
            raise_on("scatter_add", fn(dev.index if dev.index is not None
                                       else torch.cuda.current_device(),
                                       ctypes.byref(value)))
            self._smem_optin[dev] = value.value
        return scatter_route(T, C, self._smem_optin[dev])

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
        chk("out", out, torch.float32, tuple(out.shape))
        if g.device != dev or g.dtype != torch.float32:
            raise ValueError(f"scatter_add: g is {g.dtype} on {g.device}, "
                             f"want float32 on {dev}")
        ld_g = g.stride(0) if N > 1 else C
        if C > 1 and g.stride(1) != 1 or ld_g < C:
            raise ValueError(f"scatter_add: g's rows (strides {g.stride()}) "
                             f"are not {C} consecutive floats")
        if N == 0 or C == 0 or T == 0:
            return out
        with torch.cuda.device(dev):
            if self.route(T, C, dev) == "dense":
                plan = dense_plan(N, T, C)
                partials = torch.empty(plan.partials_shape,
                                       dtype=torch.float32, device=dev)
                err = self._fn("hrt_scatter_add_dense", self._DENSE_ARGTYPES)(
                    idx.data_ptr(), g.data_ptr(), ld_g, N, C, T, plan.blocks,
                    plan.warps, partials.data_ptr(), out.data_ptr(),
                    out.shape[1], col, _stream(dev))
            else:
                keys, perm = torch.sort(idx, stable=True)
                half = 2 * -(-N // CHUNK)  # boundary entries, first level
                scratch_g = torch.empty((2, half, C), dtype=torch.float32,
                                        device=dev)
                scratch_keys = torch.empty((2, half), dtype=torch.int32,
                                           device=dev)
                err = self._fn("hrt_scatter_add_sorted",
                               self._SORTED_ARGTYPES)(
                    keys.data_ptr(), perm.data_ptr(), g.data_ptr(), ld_g, N,
                    C, CHUNK, out.data_ptr(), T, out.shape[1], col,
                    scratch_g.data_ptr(), scratch_keys.data_ptr(),
                    _stream(dev))
        raise_on("scatter_add", err)
        self.launches += 1
        return out


scatter_add = ScatterAddKernel()


def _rows_of(g):
    """``g`` itself where its rows are unit-stride runs of floats, as the
    scatter-add reads a column window; else a contiguous copy (an expanded
    or transposed cotangent)."""
    C = g.shape[1]
    if (C <= 1 or g.stride(1) == 1) and (g.shape[0] <= 1
                                         or g.stride(0) >= C):
        return g
    return g.contiguous()


class _RowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, cols, grad_cols):
        ctx.save_for_backward(idx)
        ctx.table_shape, ctx.col = tuple(table.shape), cols[0]
        ctx.grad_cols = grad_cols
        return gather(table, idx, cols[0], cols[1] - cols[0])

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        lo, hi = ctx.grad_cols
        dtable = g.new_zeros(ctx.table_shape)
        scatter_add(idx, _rows_of(g[:, lo:hi]), ctx.table_shape[0],
                    out=dtable, col=ctx.col + lo)
        return dtable, None, None, None


def gather_rows(table, idx, cols=None, grad_cols=None):
    """``table[idx, lo:hi]`` for ``table`` f32[T, W], ``idx`` i32 of any
    shape with ids in ``[0, T)`` and ``cols = (lo, hi)`` (all columns by
    default): f32[*idx.shape, hi - lo].  The forward is :data:`gather`; the
    backward sums the rows' cotangents per table row with
    :data:`scatter_add` (the same bits in every run), where PyTorch's
    indexing backward serialises the many rows of one index.
    ``grad_cols = (a, b)``, output columns, declares every other column's
    cotangent zero: only those are summed, read in place, as JAX's
    ``bwd_cols``."""
    W = table.shape[1]
    cols = (0, W) if cols is None else cols
    grad_cols = (0, cols[1] - cols[0]) if grad_cols is None else grad_cols
    row = _RowGather.apply(table, idx.reshape(-1), cols, grad_cols)
    return row.reshape(*idx.shape, cols[1] - cols[0])
