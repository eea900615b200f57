"""The row fetch and its backward, the table scatter-add: the counterparts
of ``hermespy_rt_tpu.ops.fetch_pallas.pallas_onehot_fetch`` (``table[idx]``)
and ``::pallas_scatter_add`` (``dtable[k] = sum over r with idx[r] == k of
g[r]``).  :func:`gather_plain` and :func:`scatter_add_plain` are the plain
versions of the CUDA kernels in ``csrc/gather.cu`` and
``csrc/scatter_add.cu`` (wrappers in :mod:`.fetch_cuda`)."""
from __future__ import annotations

import torch

__all__ = ["gather_plain", "scatter_add_plain"]


def gather_plain(table, idx, col: int = 0, width=None):
    """``table[idx]`` for ``table`` f32[T, W] and ``idx`` i32[N] in
    ``[0, T)``: f32[N, width], the columns ``col .. col + width`` of each
    row (all of them by default)."""
    width = table.shape[1] - col if width is None else width
    return table[idx.long(), col:col + width]


def scatter_add_plain(idx, g, T: int):
    """``idx`` i32[N] row ids, ``g`` f32[N, C] rows; returns f32[T, C].
    Ids outside ``[0, T)`` (-1 for a dead ray) are dropped, as the TPU
    kernel's one-hot drops them."""
    keep = (idx >= 0) & (idx < T)
    out = g.new_zeros((T, g.shape[-1]))
    return out.index_add_(0, idx[keep].long(), g[keep])
