"""The work split of the two cooperative fusion kernels of the PyTorch port
(the whole-MLP kernel of ``csrc/w4a8_lowrank.cu`` and attention + o_proj of
``csrc/attn_o.cu``, both on ``csrc/fused_proj.cuh``), through the plan's
Python mirror in ``ops/kernels.py`` and ``ops/attention.py``.

The kernels run only on the card; here their plan is checked on the CPU at
Llama-2-7B and tiny widths and at 132, 7 and 1 CTAs: the warps' slab ranges
partition each stage, every (activation tile, weight row, 128-byte code
chunk) and every (tile, row, 128-rank L chunk) is one slab's exactly once,
each warp's split groups take distinct partial slots, a group's
contributors are the warps ``split_sum`` walks (the contiguous owners of
its first and last slabs when the stage has at least a slab a warp), the
counters cover every group, the fold's partial slots are one per group or
stream, and the whole-MLP kernel's xrd reduce adds every group once in an
order that does not depend on the grid.
"""

import numpy as np
import pytest

from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    LLAMA2_7B, TINY_MHA)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

WIDTHS = {"llama2-7b": LLAMA2_7B, "tiny-mha": TINY_MHA}
RANK = 128


def _check_stage(st, W):
    """Coverage, slots and contributors of one stage cut over W warps;
    returns the groups of the stage."""
    per = st["nk"] + st["nl"]
    S = K._fused_slabs(st)
    G = st["mtiles"] * st["groups"]
    assert S * W < 2 ** 32                      # the kernels' 32-bit math
    assert (st["nk"] - 1) * K._FKC < st["P"] <= st["nk"] * K._FKC
    ranges = [K._fused_range(S, w, W) for w in range(W)]
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(ranges[w][1] == ranges[w + 1][0] for w in range(W - 1))
    nrows = 2 * st["half"] if st["half"] else 32 * st["groups"]
    hits = np.zeros((st["mtiles"], nrows, per), np.int32)
    s = np.arange(S)
    Gs, c = s // per, s % per
    mt, g = Gs // st["groups"], Gs % st["groups"]
    rows = np.array([K._fused_group_rows(st, x)
                     for x in range(st["groups"])])
    for tile in (0, 1):
        r = rows[g, tile]
        for i in range(16):
            np.add.at(hits, (mt, r + i, c), 1)
    assert (hits == 1).all()
    slots = {}
    for w, (lo, hi) in enumerate(ranges):
        for GG in range(lo // per, -(-hi // per)) if lo < hi else ():
            if lo <= GG * per and hi >= (GG + 1) * per:
                continue                        # the whole group: no partial
            slot = 0 if GG == lo // per else 1
            assert slot == 0 or GG == (hi - 1) // per
            assert (w, slot) not in slots
            slots[w, slot] = GG
    lo_w, hi_w = np.array(ranges).T
    for GG in range(G):
        touch = np.flatnonzero((lo_w < hi_w) & (lo_w < (GG + 1) * per)
                               & (hi_w > GG * per)).tolist()
        walk = K._fused_contributors(GG, per, S, W)
        assert walk == touch
        if S >= W:      # every range nonempty: the owners in between
            w0 = K._fused_owner(GG * per, S, W)
            w1 = K._fused_owner((GG + 1) * per - 1, S, W)
            assert walk == list(range(w0, w1 + 1))
        if len(touch) > 1:
            assert sorted(w for (w, _), gg in slots.items()
                          if gg == GG) == touch
    return G


@pytest.mark.parametrize("name,bits,M,ctas", [
    (name, bits, M, ctas) for name in WIDTHS for bits in (2, 4, 8)
    for M in (1, 8, 33, 128) for ctas in (132, 7, 1)])
def test_mlp_plan_covers_once(name, bits, M, ctas):
    cfg = WIDTHS[name]
    h, im = cfg.hidden_size, cfg.intermediate_size
    gu, dn = K._mlp_plan(M, h, im, RANK, bits)
    assert gu["MT"] == dn["MT"] == (8 if M <= 8 else 32)
    assert gu["mtiles"] * gu["MT"] >= M > (gu["mtiles"] - 1) * gu["MT"]
    assert gu["half"] == im and gu["groups"] == im // 16
    assert dn["half"] == 0 and dn["groups"] == h // 32
    W = ctas * K._MLP_WARPS
    counters = max(_check_stage(gu, W), _check_stage(dn, W))
    # _launch_mlp's counters, the fold's slots: one amax and one xrd slot
    # per gate/up group
    assert counters == max(gu["mtiles"] * gu["groups"],
                           dn["mtiles"] * dn["groups"])
    # the xrd reduce: every group once, a chain per lane in group order,
    # the same whatever the grid
    terms = K._mlp_xrd_terms(gu["groups"], gu["MT"])
    flat = sorted(g for warp in terms for chain in warp for g in chain)
    assert flat == list(range(gu["groups"]))
    assert all(chain == sorted(chain) for warp in terms for chain in warp)
    assert len(terms) == K._MLP_WARPS
    assert all(len(warp) == 32 // gu["MT"] for warp in terms)


@pytest.mark.parametrize("name,bits,B,ctas", [
    (name, bits, B, ctas) for name in WIDTHS for bits in (2, 4, 8)
    for B in (1, 8, 32) for ctas in (132, 7, 1)])
def test_attn_o_plan_covers_once(name, bits, B, ctas):
    cfg = WIDTHS[name]
    qdim, h = cfg.q_dim, cfg.hidden_size
    (st,) = AT._attn_o_plan(B, qdim, h, RANK, bits)
    assert st["MT"] == (8 if B <= 8 else 32) and st["mtiles"] == 1
    assert st["half"] == 0 and st["groups"] == h // 32
    assert st["nl"] == RANK // K._FKC
    G = _check_stage(st, ctas * K._ATTN_O_WARPS)
    assert G == h // 32          # _launch_attn_o's counters
    # the fold: one xro partial row a (b, head) stream, each stream's
    # columns one 128-wide K chunk of xro
    assert qdim % cfg.head_dim == 0 and cfg.head_dim == 128
