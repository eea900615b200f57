"""PyTorch port vs JAX package: the table scatter-add's summation order and
the launch plans of the scatter-add and the row gather.

``scatter_add_ordered_plain`` sums in exactly the grouping of the
scatter-add kernel's dense route (``csrc/scatter_add.cu``: each warp's rows
in row order, then the warps of a block, then the blocks); the kernel must
equal it bit for bit on the card (``tests/test_torch_cuda.py``).  Here it is
held against the JAX package's ``pallas_scatter_add`` (interpret mode) and
against the float64 sum, each table entry within ``SUM_RTOL`` of the sum of
its terms' magnitudes (the sums are taken in other orders).  The plans
(which route, how many blocks and warps, which rows a warp owns; the
gather's 32-row groups) are pure Python and checked at the shapes the
tracer gives them."""
import _torch_threads  # noqa: F401  (first: the thread share)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hermespy_rt_tpu.ops.fetch_pallas import pallas_scatter_add
from hermespy_rt_tpu_torch import testing as checks
from hermespy_rt_tpu_torch.ops.fetch import (
    GATHER_STAGE_BYTES, SCATTER_BLOCKS, SCATTER_MAX_WARPS,
    SCATTER_SMEM_BUDGET, dense_plan, gather_plan, scatter_add_ordered_plain,
    scatter_add_plain, scatter_route)
from hermespy_rt_tpu_torch.ops.fetch_cuda import _rows_of, scatter_add

CANYON_T, CITY_T, MATERIALS = 256, 131072, 300
H100_SMS = 132


def _inputs(seed, N, T, C):
    """Ids that fall off both ends of ``[0, T)``, a long run of one id, and
    rows of g spread over 12 decades."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-5, T + 5, N).astype(np.int32)
    idx[N // 5:N // 5 + N // 4] = 7                  # a long run of one row
    g = (rng.normal(size=(N, C))
         * 10.0 ** rng.integers(-6, 6, (N, C))).astype(np.float32)
    return idx, g


def _within_sum_rtol(ours, ref, idx, g, T, label):
    """Each entry within SUM_RTOL of the float64 sum of its terms'
    magnitudes."""
    scale = scatter_add_plain(torch.as_tensor(idx),
                              torch.as_tensor(g).double().abs(), T)
    err = (torch.as_tensor(np.array(ours)).double()
           - torch.as_tensor(np.array(ref)).double()).abs()
    bad = err > checks.SUM_RTOL * scale + 1e-30
    assert not bool(bad.any()), f"{label}: {int(bad.sum())} sums beyond tier"


@pytest.mark.parametrize("N,T,C", [(20011, CANYON_T, 27),
                                   (20011, CANYON_T, 12),
                                   (20011, CANYON_T, 3),
                                   (9000, MATERIALS, 12)])
def test_ordered_plain_matches_pallas_and_float64(N, T, C):
    idx, g = _inputs(C + T, N, T, C)
    ours = scatter_add_ordered_plain(torch.as_tensor(idx), torch.as_tensor(g),
                                     T)
    assert ours.shape == (T, C) and ours.dtype == torch.float32
    plan = dense_plan(N, T, C)
    # a ragged last group, and warps with one group fewer than others
    assert N % 32 and -(-N // 32) % (plan.blocks * plan.warps)
    ref = pallas_scatter_add(jnp.asarray(idx), jnp.asarray(g), T, True)
    _within_sum_rtol(ours, ref, idx, g, T, "vs pallas_scatter_add")
    exact = scatter_add_plain(torch.as_tensor(idx),
                              torch.as_tensor(g).double(), T)
    _within_sum_rtol(ours, exact, idx, g, T, "vs float64")
    # the dropped ids' rows are not summed: rows of NaN there change nothing
    g_nan = g.copy()
    g_nan[(idx < 0) | (idx >= T)] = np.nan
    assert torch.equal(scatter_add_ordered_plain(
        torch.as_tensor(idx), torch.as_tensor(g_nan), T), ours)


def test_ordered_plain_edges():
    """N = 0, a column window of a wider g (read where it lies), and one
    row."""
    empty = scatter_add_ordered_plain(torch.zeros(0, dtype=torch.int32),
                                      torch.zeros((0, 27)), CANYON_T)
    assert empty.shape == (CANYON_T, 27) and not empty.any()
    idx, g = _inputs(5, 3000, CANYON_T, 40)
    window = torch.as_tensor(g)[:, 13:25]
    assert not window.is_contiguous()
    assert torch.equal(
        scatter_add_ordered_plain(torch.as_tensor(idx), window, CANYON_T),
        scatter_add_ordered_plain(torch.as_tensor(idx), window.contiguous(),
                                  CANYON_T))
    one = scatter_add_ordered_plain(torch.tensor([3], dtype=torch.int32),
                                    torch.ones((1, 12)), CANYON_T)
    assert float(one.sum()) == 12.0 and float(one[3].sum()) == 12.0


def test_ordered_plain_grouping():
    """The grouping is the plan's: a sum by hand over the plan's row ranges
    gives the same bits, and ``ones`` count rows exactly."""
    idx = np.full(4099, 9, np.int32)
    ones = scatter_add_ordered_plain(torch.as_tensor(idx),
                                     torch.ones((4099, 3)), CANYON_T)
    assert torch.equal(ones[9], torch.full((3,), 4099.0))
    rng = np.random.default_rng(11)
    g = torch.as_tensor((rng.normal(size=(4099, 3)) * 10.0 ** rng.integers(
        -7, 7, (4099, 3))).astype(np.float32))
    plan = dense_plan(4099, CANYON_T, 3)
    # by hand: each warp's range in row order, warps, then blocks
    want = torch.zeros(3)
    for b in range(plan.blocks):
        block = torch.zeros(3)
        for q in range(plan.warps):
            warp = torch.zeros(3)
            for r in plan.rows(b, q, 4099):
                warp = warp + g[r]
            block = block + warp
        want = want + block
    got = scatter_add_ordered_plain(torch.as_tensor(idx), g, CANYON_T)
    assert torch.equal(got[9], want)


@pytest.mark.parametrize("T,C,warps", [(CANYON_T, 27, 8), (CANYON_T, 12, 16),
                                       (CANYON_T, 3, 16),
                                       (MATERIALS, 12, 16)])
def test_dense_plan_at_the_tracers_shapes(T, C, warps):
    """The canyon's payload (27 columns), eta (12) and normal (3) windows
    and a 300-row material table take the dense route: every row owned by
    one warp, in row order, whole 32-row groups dealt to the blocks in turn,
    then to their warps, over one fixed grid."""
    assert scatter_route(T, C, SCATTER_SMEM_BUDGET) == "dense"
    for N in (1 << 20, (1 << 16) + 77, 31):
        plan = dense_plan(N, T, C)
        assert plan.warps == warps
        assert plan.smem_bytes == warps * T * C * 4 <= SCATTER_SMEM_BUDGET
        assert plan.blocks == min(SCATTER_BLOCKS, -(-N // 32))
        assert plan.partials_shape == (plan.blocks, T, C)
        assert plan.blocks * plan.warps * plan.groups_per_warp * 32 >= N
        owned = [plan.rows(b, q, N) for b in range(plan.blocks)
                 for q in range(plan.warps)]
        assert sorted(r for rows in owned for r in rows) == list(range(N))
        assert all(rows == sorted(rows) for rows in owned)
        assert plan.rows(0, 0, N)[:32] == list(range(min(N, 32)))
        if plan.blocks > 1:
            assert plan.rows(1, 0, N)[:32] == list(range(32, min(N, 64)))
    big = dense_plan(1 << 20, T, C)
    if C == 27:
        assert big == (132, 8, 32, 221184, (132, 256, 27))


def test_dense_plan_spreads_a_compacted_prefix():
    """Compacted rays put every kept row first: G's first call keeps the
    first 7,699 of 2^20 rows, its busiest 181,780.  Dealt in groups, no warp
    gets more than its share of them."""
    plan = dense_plan(1 << 20, CANYON_T, 27)
    for kept in (7699, 181780):
        per_warp = [sum(r < kept for r in plan.rows(b, q, 1 << 20))
                    for b in range(plan.blocks) for q in range(plan.warps)]
        share = 32 * -(-kept // (32 * plan.blocks * plan.warps))
        assert max(per_warp) == share
        assert sum(per_warp) == kept


def test_route_for_large_tables_and_small_cards():
    """The config-5 city's 131,072 rows take the sorted route; so do the
    canyon's 27- and 12-column tables where a card allows 48 KB a block;
    more than 32 columns never take the dense route (one lane a column)."""
    assert dense_plan(1 << 20, CITY_T, 27) is None
    assert scatter_route(CITY_T, 27, SCATTER_SMEM_BUDGET) == "sorted"
    assert scatter_route(CITY_T, 3, SCATTER_SMEM_BUDGET) == "sorted"
    assert scatter_route(CANYON_T, 27, 48 * 1024) == "sorted"
    # the warps of a block do not shrink to fit a card: the grouping stays
    assert scatter_route(CANYON_T, 12, 48 * 1024) == "sorted"
    small = dense_plan(1 << 20, CANYON_T, 3)                # 16 x 3 KB
    assert scatter_route(CANYON_T, 3, small.smem_bytes) == "dense"
    assert scatter_route(CANYON_T, 3, small.smem_bytes - 1) == "sorted"
    assert scatter_route(16, 33, SCATTER_SMEM_BUDGET) == "sorted"
    assert dense_plan(100, 2152, 27).warps == 1      # the largest canyon-
    assert dense_plan(100, 2153, 27) is None         # width table that fits
    assert dense_plan(1 << 20, 4, 1).warps == SCATTER_MAX_WARPS


def test_gather_plan_groups():
    """N = 2^16 + 77 ids: 2050 whole 32-row groups, each 128 C bytes (whole
    16-byte vectors, so every group starts aligned), then a ragged tail of
    13 rows; the canyon's table staged, the city's not."""
    N = (1 << 16) + 77
    plan = gather_plan(N, CANYON_T, 27, H100_SMS)
    assert (plan.full_groups, plan.tail_rows) == (2050, 13)
    assert 32 * plan.full_groups + plan.tail_rows == N
    assert plan.vectors_per_group == 216 and plan.bytes_per_group == 3456
    assert plan.vectors_per_group * 16 == plan.bytes_per_group == 32 * 27 * 4
    assert plan.staged and plan.smem_bytes == 256 * 27 * 4
    assert plan.blocks == -(-2051 // 16)             # fewer groups than SMs
    for C in range(1, 33):
        p = gather_plan(N, CANYON_T, C, H100_SMS)
        assert p.bytes_per_group % 16 == 0
        # the tail starts 16-byte aligned too: after whole groups
        assert (p.full_groups * p.bytes_per_group) % 16 == 0
    city = gather_plan(1 << 20, CITY_T, 27, H100_SMS)
    assert not city.staged and city.smem_bytes == 0
    assert (city.full_groups, city.tail_rows) == (32768, 0)
    assert city.blocks == 4 * H100_SMS
    assert gather_plan(1 << 20, CANYON_T, 27, H100_SMS).blocks == 2 * H100_SMS
    # the largest 27-column table staged: 455 x 108 B <= 48 KB < 456 x 108
    assert 455 * 27 * 4 <= GATHER_STAGE_BYTES < 456 * 27 * 4
    assert gather_plan(N, 455, 27, H100_SMS).staged
    assert not gather_plan(N, 456, 27, H100_SMS).staged
    tiny = gather_plan(5, CANYON_T, 3, H100_SMS)
    assert (tiny.full_groups, tiny.tail_rows, tiny.blocks) == (0, 5, 1)


def test_cpu_wrapper_takes_a_column_window():
    """On the CPU the wrapper runs the plain version, with g a window of a
    wider tensor; ``_rows_of`` keeps such a window and copies only rows
    that are not unit-stride runs (an expanded or transposed cotangent)."""
    idx, g = _inputs(8, 2000, CANYON_T, 30)
    it, full = torch.as_tensor(idx), torch.as_tensor(g)
    window = full[:, 15:27]
    assert _rows_of(window) is window
    out = torch.ones((CANYON_T, 27))
    scatter_add(it, window, CANYON_T, out=out, col=15)
    want = torch.ones((CANYON_T, 27))
    want[:, 15:] += scatter_add_plain(it, window.contiguous(), CANYON_T)
    assert torch.equal(out, want)
    assert scatter_add.launches == 0
    expanded = torch.ones(1, 12).expand(2000, 12)
    assert _rows_of(expanded) is not expanded
    assert _rows_of(expanded).is_contiguous()
    transposed = torch.ones(12, 2000).t()
    assert _rows_of(transposed).is_contiguous()
