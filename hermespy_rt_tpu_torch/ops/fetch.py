"""The row fetch and its backward, the table scatter-add: the counterparts
of ``hermespy_rt_tpu.ops.fetch_pallas.pallas_onehot_fetch`` (``table[idx]``)
and ``::pallas_scatter_add`` (``dtable[k] = sum over r with idx[r] == k of
g[r]``).  :func:`gather_plain` and :func:`scatter_add_plain` are the plain
versions of the CUDA kernels in ``csrc/gather.cu`` and
``csrc/scatter_add.cu`` (wrappers in :mod:`.fetch_cuda`);
:func:`scatter_add_ordered_plain` sums in exactly the grouping of the
scatter-add's dense route, so that the kernel equals it bit for bit.

The launch plans of both kernels are pure Python, here, so that the CPU
tests reach them: :func:`dense_plan` and :func:`scatter_route` (which route
the scatter-add takes, with how many blocks, warps and rows a warp),
:func:`gather_plan` (the gather's 32-row groups and its grid).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["gather_plain", "scatter_add_plain", "scatter_add_ordered_plain",
           "DensePlan", "dense_plan", "scatter_route", "GatherPlan",
           "gather_plan", "SCATTER_BLOCKS", "SCATTER_MAX_WARPS",
           "SCATTER_SMEM_BUDGET", "GATHER_STAGE_BYTES", "GATHER_THREADS"]

# The dense scatter-add's grid: at most SCATTER_BLOCKS blocks of at most
# SCATTER_MAX_WARPS warps, each warp with a private [T, C] f32 accumulator
# in shared memory.  Both are constants, and the warps a block gets depend
# on (T, C) and SCATTER_SMEM_BUDGET alone (Hopper's 227 KB a block), so the
# grouping of the adds is the same on every card.
SCATTER_BLOCKS = 132
SCATTER_MAX_WARPS = 16
SCATTER_SMEM_BUDGET = 232448
# the gather stages the table's column window in shared memory up to this
# size (no opt-in above the default 48 KB a block); larger tables are read
# from L2
GATHER_STAGE_BYTES = 48 * 1024
GATHER_THREADS = 512


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


class DensePlan(NamedTuple):
    """The dense scatter-add's launch: ``blocks`` blocks of ``warps`` warps.
    The rows are cut into groups of 32 (one coalesced load of ids); group
    ``r`` goes to block ``r mod blocks``, warp ``(r div blocks) mod
    warps``, so that kept rows spread over every warp wherever they lie; a
    warp takes at most ``groups_per_warp`` groups, in row order.
    ``smem_bytes`` of accumulators a block; the partials ``[blocks, T, C]``
    f32."""
    blocks: int
    warps: int
    groups_per_warp: int
    smem_bytes: int
    partials_shape: tuple

    def rows(self, b: int, q: int, N: int) -> list:
        """The rows of warp ``q`` of block ``b``, in the order it adds
        them."""
        first = b + self.blocks * q
        return [r for i in range(self.groups_per_warp)
                for r in range(32 * (first + self.blocks * self.warps * i),
                               min(N, 32 * (first + self.blocks * self.warps
                                            * i + 1)))]


def _warps(T: int, C: int) -> int:
    """Warps a block of the dense route gets: as many ``[T, C]`` f32
    accumulators as :data:`SCATTER_SMEM_BUDGET` holds, at most
    :data:`SCATTER_MAX_WARPS`; 0 where not one fits or ``C`` exceeds a
    warp's 32 lanes (one lane a column)."""
    per_warp = T * C * 4
    if C <= 0 or T <= 0 or C > 32 or per_warp > SCATTER_SMEM_BUDGET:
        return 0
    return min(SCATTER_MAX_WARPS, SCATTER_SMEM_BUDGET // per_warp)


def dense_plan(N: int, T: int, C: int) -> Optional[DensePlan]:
    """The dense route's plan for ``N`` rows of ``C`` columns into ``T``
    table rows (``None`` where the route cannot take them): as many blocks
    as groups of 32 rows, at most :data:`SCATTER_BLOCKS`."""
    warps = _warps(T, C)
    if warps == 0:
        return None
    groups = -(-N // 32)
    blocks = min(SCATTER_BLOCKS, groups)
    per_warp = -(-groups // (blocks * warps)) if groups else 0
    return DensePlan(blocks, warps, per_warp, warps * T * C * 4,
                     (blocks, T, C))


def scatter_route(T: int, C: int, smem_optin: int) -> str:
    """``"dense"`` where a block of :func:`dense_plan`'s warps fits the
    shared memory the card allows a block (``smem_optin`` bytes), else
    ``"sorted"``: the ids sorted, the rows summed by position (large
    tables, such as the config-5 city's 131,072 rows)."""
    warps = _warps(T, C)
    return ("dense" if warps and warps * T * C * 4 <= smem_optin
            else "sorted")


def scatter_add_ordered_plain(idx, g, T: int,
                              plan: Optional[DensePlan] = None):
    """:func:`scatter_add_plain` in exactly the dense route's grouping
    (``plan``, :func:`dense_plan`'s by default): each warp sums its groups'
    rows in row order into its own ``[T, C]`` (from zeros), each block its
    warps' sums in warp order (from zeros), then the blocks' sums in block
    order (from zeros).  Vectorised across warps, one step per row
    position; the kernel's adds are plain f32 adds, so on the card it equals
    the kernel bit for bit.  ``g`` may be a column window (any strides)."""
    N, C = g.shape
    out = g.new_zeros((T, C))
    plan = dense_plan(N, T, C) if plan is None else plan
    if N == 0:
        return out
    P, W, n_i = plan.blocks, plan.warps, plan.groups_per_warp
    pad = n_i * W * P * 32 - N
    ids = idx.long()
    # a dropped row lands on a dummy row T, and its g is not used
    ids = torch.where((ids >= 0) & (ids < T), ids, T)
    ids = torch.cat([ids, ids.new_full((pad,), T)])
    rows = torch.cat([g, g.new_zeros((pad, C))])
    # group i P W + q P + b is warp (b, q)'s i-th: rows [P W, n_i 32] in the
    # order each warp adds them
    ids = ids.view(n_i, W, P, 32).permute(2, 1, 0, 3).reshape(P * W, -1)
    rows = rows.view(n_i, W, P, 32, C).permute(2, 1, 0, 3, 4).reshape(
        P * W, -1, C)
    acc = g.new_zeros((P * W * (T + 1), C))
    base = torch.arange(P * W, device=g.device) * (T + 1)
    for u in range(n_i * 32):  # each warp's own row: no index repeats
        at = base + ids[:, u]
        acc[at] = acc[at] + rows[:, u]
    acc = acc.view(plan.blocks, plan.warps, T + 1, C)[:, :, :T]
    part = g.new_zeros((plan.blocks, T, C))
    for q in range(plan.warps):
        part += acc[:, q]
    for b in range(plan.blocks):
        out += part[b]
    return out


class GatherPlan(NamedTuple):
    """The gather's launch for N ids into ``[N, C]``: ``full_groups``
    groups of 32 rows, each written by one warp as ``8 C`` 16-byte vectors
    (``128 C`` bytes, so every group starts 16-byte aligned), then
    ``tail_rows`` rows (``N mod 32``) written one float at a time; the
    table's column window staged in shared memory (``smem_bytes``) when it
    fits :data:`GATHER_STAGE_BYTES`; ``blocks`` persistent blocks of
    :data:`GATHER_THREADS` threads."""
    full_groups: int
    tail_rows: int
    vectors_per_group: int
    bytes_per_group: int
    staged: bool
    smem_bytes: int
    blocks: int


def gather_plan(N: int, T: int, C: int, sm_count: int) -> GatherPlan:
    """:class:`GatherPlan` on a card of ``sm_count`` SMs (the output is an
    exact copy, so the grid may follow the card): 2 staged blocks an SM
    (each stages the table once), 4 unstaged (a full SM's warps), never
    more blocks than 16-warp shares of the groups."""
    full, tail = divmod(N, 32)
    staged = 0 < T * C * 4 <= GATHER_STAGE_BYTES
    warps = GATHER_THREADS // 32
    blocks = max(1, min(-(-(full + (tail > 0)) // warps),
                        (2 if staged else 4) * sm_count))
    return GatherPlan(full, tail, 8 * C, 128 * C, staged,
                      T * C * 4 if staged else 0, blocks)
