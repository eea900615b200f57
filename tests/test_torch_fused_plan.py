"""The launch plan of the whole-loop material backward
(``ops/bounce_fused_cuda.py``), on the CPU: the block's threads from the
material count (the warps' tables in shared memory), and the grid, a few
waves of blocks that the card deals out as they finish."""
import _torch_threads  # noqa: F401  (first: the thread share)

import pytest

from hermespy_rt_tpu_torch.ops import bounce_fused_cuda as fused_ops

SMEM = 232448           # the shared memory a block of an H100 may use


@pytest.mark.parametrize("M,warps", [(0, 8), (1, 8), (17, 8), (300, 8),
                                     (605, 8), (606, 7), (2421, 2),
                                     (2422, 1),
                                     (fused_ops.MAX_MATERIALS, 1)])
def test_loop_bwd_threads_fit_the_tables(M, warps):
    """Up to 8 warps a block, each with its own [M, 12] f32 table in shared
    memory; fewer warps where their tables do not fit."""
    assert fused_ops.loop_bwd_threads(M) == 32 * warps
    assert warps * max(M, 1) * 48 <= SMEM
    assert warps == 8 or (warps + 1) * M * 48 > SMEM


def test_max_materials_is_one_warp_table():
    assert fused_ops.MAX_MATERIALS == SMEM // 48 == 4842
    assert fused_ops.loop_bwd_threads(fused_ops.MAX_MATERIALS + 1) == 0


@pytest.mark.parametrize("R,threads,blocks", [
    (1 << 20, 256, 1056),          # 8 blocks an SM, each 3.9 ray tiles
    (1 << 20, 32, 1056),           # a 1-warp block of a large table
    (10_000, 256, 40),             # fewer rays than 8 blocks an SM
    (1, 256, 1),
    (257, 256, 2)])
def test_loop_bwd_blocks_fill_a_few_waves(R, threads, blocks):
    assert fused_ops.loop_bwd_blocks(R, threads, 132) == blocks
