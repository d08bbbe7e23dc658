"""PyTorch port: the work split of the block-parallel decode attention
(``ops/attention.py::_decode_split_plan``, the plan of
``csrc/flash_decode_split.cu``, and ``_split_units`` here, a mirror of the
items the kernel finds from the positions), and the paged step's page-id
check.

The kernel runs only on the card (``tests/test_torch_cuda.py``); here the
plan is held to what the kernels rely on: every live token falls in exactly
one phase-A chunk and every live block in exactly one phase-B window, chunks
and windows sit on block bounds, and the grids and scratch sizes follow
from shapes alone.
"""

import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import TINY
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import paged

SMS = 132

# (B, KVH, G, D, T, bt, attended tokens per row): the paged engine's
# 16-token pages, the all-batch kernel's 128-token blocks, pages of 1, 100,
# 256, 320 and 512 tokens, and single-block streams (bt == T, 7000 tokens)
CASES = [
    (8, 32, 1, 128, 2048, 16, [0, 300, 777, 1024, 1500, 1801, 2047, 2048]),
    (8, 32, 1, 128, 4096, 128, [0, 701, 1300, 1901, 2300, 2700, 3401, 4096]),
    (8, 32, 1, 128, 4096, 16, [273, 284, 290, 298, 301, 306, 311, 319]),
    (6, 2, 4, 128, 1024, 256, [0, 1, 256, 257, 1023, 1024]),
    (6, 2, 1, 32, 1280, 320, [0, 1, 320, 321, 1279, 1280]),
    (6, 2, 2, 64, 2048, 512, [0, 1, 512, 513, 2047, 2048]),
    (3, 1, 8, 32, 64, 1, [0, 1, 64]),
    (2, 2, 3, 48, 1000, 100, [99, 1000]),
    (1, 2, 7, 64, 7000, 7000, [7000]),
    (1, 2, 7, 64, 7000, 7000, [1]),
    (8, 4, 1, 128, 2000, 2000, [0, 250, 700, 999, 1000, 1500, 1999, 2000]),
    (2, 2, 1, 128, 256, 128, [0, 0]),
]


def _split_units(plan: dict, bt: int, attended) -> dict:
    """The live items of ``csrc/flash_decode_split.cu`` for rows attending
    ``attended[b]`` cache tokens, in ticket order within each kind: the
    rows whose streams take one W item (no cache token, or one chunk, one
    window and ``AT._SPLIT_WHOLE_BYTES`` of K), the other rows' chunks (A) as
    (b, first token, end token, first segment, end segment) and windows (B)
    as (b, first block, blocks, tokens); each once for every kv head, and
    each of the other rows' streams one C item. A mirror of the kernel's
    ``whole_row`` and of the items its rows' counts give."""
    seg, spb, asegs, nbw = (plan[n] for n in ("seg", "spb", "asegs", "nbw"))

    def seg_start(s):
        t = s // spb
        return t * bt + (s - t * spb) * seg

    def seg_end(s):
        return min(seg_start(s) + seg, (s // spb + 1) * bt)

    chunks, windows, whole = [], [], []
    for b, n in enumerate(attended):
        nb = -(-n // bt) if n > 0 else 0
        if n == 0 or (bt <= AT._SPLIT_CHUNK and n <= plan["whole_tokens"]
                      and nb <= nbw):
            whole.append(b)
            continue
        live_segs = (nb - 1) * spb + -(-(n - (nb - 1) * bt) // seg)
        for c in range(-(-live_segs // asegs)):
            s0 = c * asegs
            s1 = min(s0 + asegs, live_segs)
            chunks.append((b, seg_start(s0), min(seg_end(s1 - 1), n), s0,
                           s1))
        for c in range(-(-nb // nbw)):
            t0 = c * nbw
            k = min(nbw, nb - t0)
            windows.append((b, t0, k, min(k * bt, n - t0 * bt)))
    return dict(whole=whole, a=chunks, b=windows)


def _plan(case):
    B, KVH, G, D, T, bt, n = case
    return AT._decode_split_plan(B, KVH, G, D, T, bt, SMS), bt, n


@pytest.mark.parametrize("case", CASES)
def test_every_live_token_in_one_chunk(case):
    plan, bt, n = _plan(case)
    units = _split_units(plan, bt, n)
    seen = [np.zeros(x, dtype=int) for x in n]
    segs = [set() for _ in n]
    for b, t0, t1, s0, s1 in units["a"]:
        assert 0 <= t0 < t1 <= n[b] and t1 - t0 <= AT._SPLIT_CHUNK
        seen[b][t0:t1] += 1
        if bt <= AT._SPLIT_CHUNK:
            # whole blocks: starts on a block bound, ends on one or at the
            # row's last live token
            assert t0 % bt == 0 and (t1 % bt == 0 or t1 == n[b])
        else:
            # a piece of one block, at a 256-token step inside it
            assert t0 // bt == (t1 - 1) // bt
            assert (t0 % bt) % AT._SPLIT_CHUNK == 0
        for s in range(s0, s1):
            assert s not in segs[b]
            segs[b].add(s)
    for b in units["whole"]:
        # a whole stream: one chunk and one window at most, no chunk here
        assert n[b] <= plan["whole_tokens"] or n[b] == 0
        assert -(-n[b] // bt) <= plan["nbw"] and not seen[b].any()
        seen[b] += 1
    for b in range(len(n)):
        assert (seen[b] == 1).all(), b
        # the live segments are 0 .. k-1, each a piece of a live block
        assert segs[b] == set(range(len(segs[b])))
        assert len(segs[b]) <= plan["nseg"]


@pytest.mark.parametrize("case", CASES)
def test_every_live_block_in_one_window(case):
    plan, bt, n = _plan(case)
    G = case[2]
    units = _split_units(plan, bt, n)
    blocks = [np.zeros(plan["nblk"], dtype=int) for _ in n]
    for b, t0, k, ntok in units["b"]:
        assert 1 <= k <= plan["nbw"]
        assert ntok == min(k * bt, n[b] - t0 * bt) > (k - 1) * bt
        blocks[b][t0:t0 + k] += 1
    for b, x in enumerate(n):
        live = -(-x // bt)
        if b in units["whole"]:
            assert not blocks[b].any()
            continue
        assert (blocks[b][:live] == 1).all() and not blocks[b][live:].any()
    # a window fits the kernel's shared memory: at most 256 tokens and 16
    # (block, head) pairs, or one block of any length
    if bt <= AT._SPLIT_CHUNK:
        assert plan["nbw"] * bt <= AT._SPLIT_CHUNK
        assert plan["nbw"] * G <= AT._SPLIT_SLOTS
    else:
        assert plan["nbw"] == 1 and plan["asegs"] == 1


@pytest.mark.parametrize("case", CASES)
def test_grids_and_scratch_from_shapes_only(case):
    B, KVH, G, D, T, bt, n = case
    plan, _, _ = _plan(case)
    streams = B * KVH
    assert plan["nblk"] * bt == T
    assert plan["nseg"] == plan["nblk"] * plan["spb"]
    assert plan["state"] == 4 * streams * plan["nblk"] * G
    assert plan["logits"] == streams * G * T
    assert plan["smax"] == streams * G * plan["nseg"]
    assert plan["contrib"] == streams * plan["nblk"] * G * D
    assert plan["counters"] == 2 + 2 * streams
    assert 1 <= plan["grid"] == min(plan["items"], SMS * AT._SPLIT_RESIDENT)
    # no positions give more items than the plan holds: a W item or its
    # chunks, windows and one C item a stream
    for full in ([T] * B, [0] * B, n):
        units = _split_units(plan, bt, full)
        rows = len(full) - len(units["whole"])
        assert (len(units["a"]) + len(units["b"]) + len(units["whole"])
                + rows) * KVH <= plan["items"]
    assert _split_units(plan, bt, [0] * B) == dict(
        whole=list(range(B)), a=[], b=[])
    # the plan reads no positions: the same shapes give the same plan
    assert AT._decode_split_plan(B, KVH, G, D, T, bt, SMS) == plan


def test_plan_rules():
    with pytest.raises(ValueError, match="no split"):
        AT._decode_split_plan(2, 2, 1, 128, 100, 30, SMS)
    with pytest.raises(ValueError, match="no split"):
        AT._decode_split_plan(2, 2, 1, 128, 16, 32, SMS)
    # a block's segment maxima must fit the kernel's window
    AT._decode_split_plan(1, 2, 8, 128, 32768, 32768, SMS)
    with pytest.raises(ValueError, match="segment maxima"):
        AT._decode_split_plan(1, 2, 8, 128, 32769, 32769, SMS)
    # any batch: the kernel takes its rows in tiles of 128
    plan = AT._decode_split_plan(300, 2, 1, 128, 256, 16, SMS)
    assert plan["counters"] == 2 + 2 * 600
    assert plan["grid"] == SMS * AT._SPLIT_RESIDENT


@pytest.mark.parametrize("bt,D,n,whole", [
    (128, 128, [0, 1, 128, 129, 192, 193, 257], [0, 1, 2, 3, 4]),
    (16, 128, [191, 192, 193], [0, 1]),
    (16, 64, [192, 193, 256], [0]),
    (320, 128, [0, 1, 320], [0])])
def test_whole_rows(bt, D, n, whole):
    # rows of one chunk, one window (128-token blocks: 2 of G 1; 16-token
    # pages: 12) and 24 KB of K, and rows with no cache token, take one W
    # item a stream
    plan = AT._decode_split_plan(len(n), 2, 1, D, 8 * bt, bt, SMS)
    assert _split_units(plan, bt, n)["whole"] == whole


@pytest.fixture(scope="module")
def paged_state():
    config = TINY
    params = fused.quantize_factors_int8_fused(fused.fuse_stacked(
        bench_params.build_compressed_llama_params(config, rank=16, seed=0,
                                                   device="cpu")))
    return config, params


def test_paged_step_checks_page_ids_once(paged_state, monkeypatch):
    config, params = paged_state
    pool = paged.PagedQuantKVPool.create(config, 6, 16, device="cpu")
    tables = torch.tensor([[0, 1, 2], [3, 4, 0]], dtype=torch.int32)
    args = (params, torch.tensor([1, 2]),
            torch.tensor([20, 5], dtype=torch.int32), pool, tables, config)
    calls = []
    check = AT._check_pages

    def counted(*a):
        calls.append(a)
        return check(*a)

    monkeypatch.setattr(AT, "_check_pages", counted)
    before = AT.flash_decode_q8_paged.launches
    logits, _ = paged.paged_decode_step_fused(*args)
    assert bool(torch.isfinite(logits).all())
    # one host read-back of the tables for the whole step, not one a layer
    assert len(calls) == 1 and calls[0][1] == pool.num_pages
    # CPU tensors run the plain version: no launch counted
    assert AT.flash_decode_q8_paged.launches == before
    bad = tables.clone()
    bad[1, 2] = pool.num_pages
    with pytest.raises(IndexError, match="out of range"):
        paged.paged_decode_step_fused(*args[:4], bad, config)
    bad[1, 2] = -1
    with pytest.raises(IndexError, match="out of range"):
        paged.paged_decode_step_fused(*args[:4], bad, config)

