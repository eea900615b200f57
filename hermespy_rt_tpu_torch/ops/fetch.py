"""The table scatter-add, the counterpart of
``hermespy_rt_tpu.ops.fetch_pallas.pallas_scatter_add``:
``dtable[k] = sum over r with idx[r] == k of g[r]``, the backward of a row
fetch.  :func:`scatter_add_plain` is the plain version of the CUDA kernel in
``csrc/scatter_add.cu`` (wrapper in :mod:`.fetch_cuda`)."""
from __future__ import annotations

import torch

__all__ = ["scatter_add_plain"]


def scatter_add_plain(idx, g, T: int):
    """``idx`` i32[N] row ids, ``g`` f32[N, C] rows; returns f32[T, C].
    Ids outside ``[0, T)`` (-1 for a dead ray) are dropped, as the TPU
    kernel's one-hot drops them."""
    keep = (idx >= 0) & (idx < T)
    out = g.new_zeros((T, g.shape[-1]))
    return out.index_add_(0, idx[keep].long(), g[keep])
