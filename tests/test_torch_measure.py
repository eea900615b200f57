"""The port's yardstick (``hermespy_rt_tpu_torch/measure.py``), on the CPU:
the bound, the walk prepass's bounds against counts made by hand on a
small query, the prune's operation count against its source, the
whole-loop backward's bytes and operations against a count by hand, and
the ``ptxas`` parser on a build log's lines."""
import _torch_threads  # noqa: F401  (first: the thread share)

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hermespy_rt_tpu_torch import measure
from hermespy_rt_tpu_torch.ops.bounce_fused import FusedSpec
from hermespy_rt_tpu_torch.ops.walk import prepass_kept_plain, query_limits

WALK_CU = (Path(measure.__file__).parent / "csrc" / "walk.cu").read_text()

PTXAS = """\
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__6fe43ad4_7_walk_cu_\
990d583019walk_prepass_kernelEPKfS1_S1_iS1_iPi' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__6fe43ad4_7_walk_cu_\
990d583019walk_prepass_kernelEPKfS1_S1_iS1_iPi
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 60 registers, used 1 barriers, 28288 bytes smem
ptxas info    : Compile time = 17.211 ms
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__6fe43ad4_7_walk_cu_\
990d583011walk_kernelEPKfS1_S1_iPKiS1_iS3_iS3_PfPii' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__6fe43ad4_7_walk_cu_\
990d583011walk_kernelEPKfS1_S1_iPKiS1_iS3_iS3_PfPii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 40960 bytes smem
"""


def test_bound_is_the_larger_time():
    assert measure.bound(3.35e9, 0) == pytest.approx((1.0, "bytes"))
    assert measure.bound(0, 67e9) == pytest.approx((1.0, "operations"))
    t, by = measure.bound(3.35e9, 2 * 67e9)
    assert (t, by) == (pytest.approx(2.0), "operations")


def test_prune_operations_match_the_source():
    """``PRUNE_OPS_PER_BOX`` counts ``walk.cu::box_pruned``: per axis and
    face 2 subtractions, 4 products, 3 min and 3 max; per axis the faces'
    min and max; the axes' joins and the 3 compares."""
    body = WALK_CU[WALK_CU.index("bool box_pruned("):]
    body = body[:body.index("\n}\n")]
    face = body[body.index("for (int h"):body.index("const float n_a")]
    assert face.count("plane - b[") == 2
    assert len(re.findall(r"d_(?:lo|hi) \* b\[", face)) == 4
    assert face.count("min_nan(") == 3 and face.count("max_nan(") == 3
    assert measure.PRUNE_OPS_PER_BOX == 3 * (2 * 12 + 2) + 4 + 3 == 85
    assert len(re.findall(r"fu < 0\.0f|nl > fu|nl > b\[12\]", body)) == 3


@pytest.mark.parametrize("kept_share", ["prune", "none"])
def test_prepass_bounds_count_by_hand(kept_share):
    """Two ray tiles, 300 rays along +x of which 100 live (all in the
    first tile), four boxes, one behind the rays: the pairs, the kept pairs
    and both bounds as counted by hand."""
    rng = np.random.default_rng(0)
    R, C = 300, 4
    o = torch.as_tensor(rng.uniform(-1, 1, (R, 3)).astype(np.float32))
    d = np.concatenate([np.ones((R, 1)), rng.uniform(0.1, 0.2, (R, 2))], 1)
    d = torch.as_tensor(d.astype(np.float32))
    live = torch.zeros(R, dtype=torch.bool)
    live[:100] = True
    lim = query_limits(R, 256, t_max=50.0, live=live, device="cpu")
    boxes = torch.tensor([[-1, -1, -1, 1, 1, 1], [-91, -1, -1, -90, 1, 1],
                          [-9, -9, -9, 9, 9, 9], [2, 2, 2, 3, 3, 3]],
                         dtype=torch.float32)
    kept = (prepass_kept_plain(o, d, lim, boxes, 256)
            if kept_share == "prune" else None)
    per_tile = (lim >= 0).reshape(-1, 256).sum(1)
    assert per_tile.tolist() == [100, 0]
    n_bytes = measure.nbytes(o, d, lim, boxes,
                             torch.zeros((2, 1 + C), dtype=torch.int32))
    assert n_bytes == 24 * R + 4 * 512 + 24 * C + 4 * 2 * (1 + C)
    out = measure.prepass_bounds(n_bytes, per_tile, C, kept)
    all_ops = 28 * 100 * C
    assert out["pairs"] == 400 and out["live_tiles"] == 1
    assert out["all_pairs"] == measure.bound(n_bytes, all_ops)
    assert out["all_pairs_half_rate"] == measure.bound(n_bytes, 2 * all_ops)
    if kept is None:
        assert "kept" not in out
        return
    assert not bool(kept[0, 1]) and bool(kept[0, 2])   # behind out, around in
    assert not bool(kept[1].any())                      # no live ray
    n_kept = int(kept[0].sum())
    assert out["kept_pairs"] == 100 * n_kept
    assert out["kept"] == measure.bound(
        n_bytes, 28 * 100 * n_kept + measure.PRUNE_OPS_PER_BOX * 1 * C)


def test_kernel_ptxas_reads_registers_and_spills():
    assert measure.kernel_ptxas(PTXAS, "walk_prepass_kernel") == dict(
        registers=60, spill_stores=8, spill_loads=12, smem_bytes=28288)
    assert measure.kernel_ptxas(PTXAS, "walk_kernel") == dict(
        registers=96, spill_stores=0, spill_loads=0, smem_bytes=40960)
    assert measure.kernel_ptxas(PTXAS, "nearest_hit_kernel") is None


def test_loop_bwd_work_counts_by_hand():
    """The whole-loop backward's bytes and operations on a small case
    counted by hand: B = 2 bounces, nrx = 2, R = 5 rays, M = 3 materials;
    live rays (bounce, ray) (0, 0), (0, 1), (1, 1); written (ray, RX)
    (0, 0, 0), (0, 0, 1) and (1, 1, 0)."""
    B, nrx, R, M = 2, 2, 5, 3
    spec = FusedSpec(nrx=nrx, grad_positions=False, grad_geometry=False)
    live = torch.zeros((B, R), dtype=torch.bool)
    live[0, 0] = live[0, 1] = live[1, 1] = True
    res_post = torch.zeros((B, nrx, 6, R))
    res_post[0, 0, 5, 0] = res_post[0, 1, 5, 0] = res_post[1, 0, 5, 1] = 0.5
    args = (torch.zeros((M, 12)), torch.zeros((B + 1, 6, R)), live,
            torch.zeros((B, R), dtype=torch.int32), torch.zeros((B, 3, R)),
            res_post, torch.zeros((B, nrx, 6, R)))
    outs = (torch.zeros((6, R)), torch.zeros((M, 12)))
    n_bytes, n_ops = measure.bwd_work("loop_bwd_slim", spec, args, outs)
    # the eta table, the live flags, both outputs and every d_out row 5;
    # per live ray its material, state rows 0-3, 3 res_pre rows and a wf
    # per RX; per ray written at a bounce its next state rows 0-3; per
    # written (ray, RX) res_post and d_out rows 0-4
    assert n_bytes == (M * 48 + B * R + 6 * R * 4 + M * 48
                       + B * nrx * R * 4
                       + 3 * (4 + 16 + 12 + 4 * nrx) + 2 * 16 + 3 * 40)
    assert n_ops == 3 * measure.BWD_PRE_OPS + 3 * measure.BWD_POST_OPS
