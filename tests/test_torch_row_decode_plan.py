"""PyTorch port: the plan of the row decode kernel
(``ops/attention.py::_row_decode_plan``, the launch of
``csrc/flash_decode.cu``) and ``_row_ranges``, the mirror of the blocks each
CTA of a stream's cluster takes.

The kernel runs only on the card (``tests/test_torch_cuda.py``); here the
plan is held to what the kernel relies on: every live block of every stream
falls in exactly one CTA's contiguous range, in block order; the cluster
size is 1-8 and comes from shapes alone; the shared memory fits; blocks
over 256 tokens take the walk, and caches of shorter blocks longer than
eight CTAs' shared memory holds the block-parallel kernel.
"""

import numpy as np
import pytest

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT

SMS = 132

# (B, KVH, G, D, T): the bench shape, Llama-2-7B over 512, 2048 and 4096
# tokens, one row and 32 rows, Llama-3-8B's and Qwen2-0.5B's GQA heads (also
# at the longest caches the row kernel takes), odd caches (blocks of 4 and 8
# tokens), tiny widths
SHAPES = [
    (8, 32, 1, 128, 256), (8, 32, 1, 128, 512), (8, 32, 1, 128, 2048),
    (1, 32, 1, 128, 4096), (32, 32, 1, 128, 256), (8, 8, 4, 128, 2048),
    (8, 2, 7, 64, 2048), (3, 2, 8, 64, 300), (2, 2, 1, 128, 1000),
    (260, 2, 2, 64, 512), (1, 1, 8, 16, 64), (6, 2, 7, 32, 2048),
    (8, 8, 4, 128, 16384), (8, 2, 7, 64, 14336),
]


def _attended(T, staged):
    """Positions 0, 1, T - 1, T and one past T as attended tokens."""
    return sorted({min(p + (0 if staged else 1), T)
                   for p in (0, 1, T // 3, T - 1, T, T + 5)})


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_live_block_once(shape):
    B, KVH, G, D, T = shape
    bt = AT.resolve_block_t(256, T)
    plan = AT._row_decode_plan(B, KVH, G, D, T, bt, SMS)
    assert plan["route"] == "row"
    C = plan["cluster"]
    assert 1 <= C <= 8 and plan["grid"] == B * KVH * C
    assert plan["maxb"] == -(-(T // bt) // C)
    assert plan["smem"] <= AT._ROW_MAX_SMEM
    assert plan["nbw"] * bt <= AT._ROW_WIN
    assert plan["nbw"] * G <= AT._ROW_WIN_PAIRS
    assert plan["maxb"] * G <= AT._ROW_MAX_PAIRS
    for staged in (True, False):
        for n in _attended(T, staged):
            nb = -(-n // bt) if n > 0 else 0
            ranges = AT._row_ranges(plan, nb)
            assert len(ranges) == C
            covered = [j for lo, hi in ranges for j in range(lo, hi)]
            assert covered == list(range(nb))       # once each, in order
            for lo, hi in ranges:
                assert 0 <= lo <= hi <= nb and hi - lo <= plan["maxb"]


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_comes_from_shapes_only(shape):
    # the plan takes no positions: the same dict whatever the rows hold,
    # and a smaller card or more streams never takes a larger cluster
    B, KVH, G, D, T = shape
    bt = AT.resolve_block_t(256, T)
    plan = AT._row_decode_plan(B, KVH, G, D, T, bt, SMS)
    assert plan == AT._row_decode_plan(B, KVH, G, D, T, bt, SMS)
    assert (AT._row_decode_plan(B, KVH, G, D, T, bt, 1)["cluster"]
            <= plan["cluster"])
    assert (AT._row_decode_plan(2 * B, KVH, G, D, T, bt, SMS)["cluster"]
            <= plan["cluster"])
    assert plan["smem"] == AT._row_smem(G, D, bt, plan["maxb"], plan["nbw"],
                                        plan["cluster"])


@pytest.mark.parametrize("T,bt", [(2000, 2000), (4096, 512), (1024, 1024)])
def test_blocks_over_256_tokens_take_the_walk(T, bt):
    plan = AT._row_decode_plan(4, 2, 1, 128, T, bt, SMS)
    assert plan["route"] == "walk" and plan["cluster"] == 0
    assert plan["grid"] == 8


def test_long_caches_of_small_blocks_take_the_split_kernel():
    # 1-token blocks over 2048 tokens: 256 blocks a CTA even at 8 CTAs, over
    # the pairs a CTA's shared memory holds
    plan = AT._row_decode_plan(2, 2, 1, 128, 2048, 1, SMS)
    assert plan["route"] == "split"
    assert AT._row_decode_plan(2, 2, 1, 128, 2048, 16, SMS)["route"] == "row"


# (KVH, G, D, the longest cache of 256-token blocks the row kernel takes at
# B 8 on 132 SMs): Llama-2-7B's, Llama-3-8B's and Qwen2-0.5B's heads; the
# numbers the plan's docstring states
@pytest.mark.parametrize("KVH,G,D,limit", [(32, 1, 128, 57344),
                                           (8, 4, 128, 16384),
                                           (2, 7, 64, 14336)])
def test_long_caches_take_the_split_kernel(KVH, G, D, limit):
    for T in (limit - 256, limit):
        plan = AT._row_decode_plan(8, KVH, G, D, T, 256, SMS)
        assert plan["route"] == "row" and plan["cluster"] >= 7
        assert plan["smem"] <= AT._ROW_MAX_SMEM
    for T in (limit + 256, 4 * limit):
        assert AT._row_decode_plan(8, KVH, G, D, T, 256, SMS) == dict(
            route="split", cluster=0, nbw=0, maxb=0, smem=0, grid=0)


# (KVH, the cluster the plan takes): B 8 rows over 8 blocks (GQA heads over
# 2048 tokens in 256-token blocks, one head over 128 in 16-token blocks) on
# 132 SMs; the card tests reach each cluster size with these shapes
@pytest.mark.parametrize("KVH,C", [(2, 8), (8, 4), (16, 3), (32, 2), (33, 1)])
def test_cluster_sizes_from_streams(KVH, C):
    for G, T, bt in ((4, 2048, 256), (1, 128, 16)):
        plan = AT._row_decode_plan(8, KVH, G, 128, T, bt, SMS)
        assert plan["route"] == "row" and plan["cluster"] == C
        assert plan["grid"] == 8 * KVH * C
        assert plan["maxb"] == -(-(T // bt) // C)
