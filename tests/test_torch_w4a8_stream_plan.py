"""The work split of the W4A8 kernel's persistent launch at decode M
(``csrc/w4a8_stream.cuh``, ``K.quantized_matmul_w4a8_stacked_persistent``
at M <= 8) through its plan's Python mirror, ``K._w4a8_stream_plan``.

The kernel runs only on the card; here its plan is checked on the CPU at
Llama-2-7B's o, down and qkv widths and at tiny widths, at 132, 7 and 1
SMs, bits 2, 4 and 8 and M 1 to 8: the warps' slab ranges partition the
layer, contiguous and even to within one slab, every (group of 32 rows,
128-byte chunk) is one slab's exactly once and the chunks cover each packed
row, every warp has a slab, a group's contributors are the contiguous
owners of its first and last slabs, the counters and sums cover every
group, and the kernel's 32-bit indices hold. A numpy model of the kernel's
walk (each warp's partial sums of its slabs, added into the group's sums,
the last of the counted contributors reading the totals) gives the exact
integer product at tiny widths, whichever contributor comes last.
"""

import numpy as np
import pytest

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

# (N, K): Llama-2-7B's o, down and fused qkv, then tiny widths (N not a
# multiple of 32 or of 16, a single slab, chunks ragged at 2 bits)
WIDTHS = {"o": (4096, 4096), "down": (4096, 11008), "qkv": (12288, 4096),
          "tiny": (96, 256), "ragged": (200, 512), "one-slab": (8, 128),
          "ragged-chunk": (40, 1088)}
LLAMA = ("o", "down", "qkv")


@pytest.mark.parametrize("name,bits,sms", [
    (name, bits, sms) for name in WIDTHS for bits in (2, 4, 8)
    for sms in (132, 7, 1)])
def test_stream_plan_covers_once(name, bits, sms):
    N, Kd = WIDTHS[name]
    plans = [K._w4a8_stream_plan(M, N, Kd, bits, sms) for M in range(1, 9)]
    assert all(p == plans[0] for p in plans)   # the split does not depend on M
    p = plans[0]
    P, nk, groups, S, W = p["P"], p["nk"], p["groups"], p["slabs"], p["W"]
    assert P * (8 // bits) == Kd
    assert (nk - 1) * K._STREAM_KC < P <= nk * K._STREAM_KC
    assert groups * K._STREAM_ROWS >= N > (groups - 1) * K._STREAM_ROWS
    assert S == groups * nk
    assert W == p["ctas"] * p["warps"] and 1 <= p["warps"] <= 8
    assert p["ctas"] <= sms and S >= W
    assert p["warps"] == max(1, min(8, S // sms))
    if name in LLAMA:
        assert p["ctas"] == sms                     # every SM busy
    # 32-bit indices: the range math, outputs, the layer's bytes in size_t
    assert S * W < 2 ** 32
    assert 8 * N < 2 ** 31 and groups * K._STREAM_ROWS * P < 2 ** 62
    assert Kd <= K._STREAM_MAX_K
    ranges = [K._fused_range(S, w, W) for w in range(W)]
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(ranges[w][1] == ranges[w + 1][0] for w in range(W - 1))
    sizes = {hi - lo for lo, hi in ranges}
    assert sizes <= {S // W, -(-S // W)} and min(sizes) >= 1
    assert p["per_warp"] == (S // W, -(-S // W))
    hits = np.zeros((groups, nk), np.int32)
    for w, (lo, hi) in enumerate(ranges):
        s = np.arange(lo, hi)
        np.add.at(hits, (s // nk, s % nk), 1)
        assert all(K._fused_owner(x, S, W) == w for x in (lo, hi - 1))
    assert (hits == 1).all()
    # contributors, counters and sums
    most = 0
    lo_w, hi_w = np.array(ranges).T
    for G in range(groups):
        g0, g1 = G * nk, (G + 1) * nk
        touch = np.flatnonzero((lo_w < g1) & (hi_w > g0)).tolist()
        w0, w1 = K._fused_owner(g0, S, W), K._fused_owner(g1 - 1, S, W)
        assert touch == list(range(w0, w1 + 1))
        assert K._fused_contributors(G, nk, S, W) == touch
        most = max(most, len(touch))
        if len(touch) == 1:
            lo, hi = ranges[touch[0]]
            assert lo <= g0 and hi >= g1        # whole in one warp
    assert p["contributors"] == most
    # a counter a group, then each group's 8 sums a lane
    assert p["counters"] == groups * (1 + K._STREAM_SUMS)
    assert K._STREAM_SUMS == 8 * 32


@pytest.mark.parametrize("name", ["tiny", "ragged", "one-slab",
                                  "ragged-chunk"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("sms", [132, 7, 1])
def test_stream_walk_model_is_exact(name, bits, sms):
    # each warp sums its slabs of a group; a split group's partials are
    # added into the group's sums, and the last of the w1 - w0 + 1 counted
    # contributors (any of them) reads the totals: the exact integer
    # product, and the sums and counters are zero again after the walk
    N, Kd = WIDTHS[name]
    M = 8
    f = 8 // bits
    maxq = 2 ** (bits - 1) - 1
    rng = np.random.default_rng(19 + bits + N + sms)
    p = K._w4a8_stream_plan(M, N, Kd, bits, sms)
    P, nk, S, W = p["P"], p["nk"], p["slabs"], p["W"]
    x = rng.integers(-127, 128, size=(M, Kd)).astype(np.int64)
    u = rng.integers(0, 2 ** bits, size=(N, Kd)).astype(np.int64)
    rows = np.zeros((p["groups"] * 32, Kd), np.int64)
    rows[:N] = u - maxq
    want = x @ (u - maxq).T

    def slab(s):
        # chunk c holds packed bytes [128 c, 128 c + 128) of the group's
        # rows: codes k = j + q P of every plane q
        G, c = divmod(s, nk)
        j = np.arange(c * 128, min(P, c * 128 + 128))
        k = (j[None, :] + P * np.arange(f)[:, None]).ravel()
        return G, x[:, k] @ rows[32 * G:32 * G + 32, k].T

    got = np.zeros((M, p["groups"] * 32), np.int64)
    sums = np.zeros((p["groups"], M, 32), np.int64)
    cnt = np.zeros(p["groups"], np.int64)
    order = rng.permutation(W)      # the warps finish in any order
    for w in order:
        lo, hi = K._fused_range(S, w, W)
        acc = {}
        for s in range(lo, hi):
            G, part = slab(s)
            acc[G] = acc.get(G, 0) + part
        for G, a in acc.items():
            if lo <= G * nk and hi >= (G + 1) * nk:
                got[:, 32 * G:32 * G + 32] = a
                continue
            sums[G] += a
            w0 = K._fused_owner(G * nk, S, W)
            w1 = K._fused_owner((G + 1) * nk - 1, S, W)
            cnt[G] += 1
            if cnt[G] == w1 - w0 + 1:           # the last contributor
                got[:, 32 * G:32 * G + 32] = sums[G]
                sums[G] = 0
                cnt[G] = 0
    np.testing.assert_array_equal(got[:, :N], want)
    assert not sums.any() and not cnt.any()


def test_stream_plan_rules():
    with pytest.raises(ValueError, match="1 to 8"):
        K._w4a8_stream_plan(9, 4096, 4096, 4)
    with pytest.raises(ValueError, match="1 to 8"):
        K._w4a8_stream_plan(0, 4096, 4096, 4)
    with pytest.raises(ValueError, match="i32 sums"):
        K._w4a8_stream_plan(8, 64, K._STREAM_MAX_K + 16, 8)
    # K 24576 at M 8, which the old persistent kernel could not stage in
    # shared memory: one CTA an SM, 128 groups x 96 chunks
    p = K._w4a8_stream_plan(8, 4096, 24576, 4)
    assert (p["ctas"], p["warps"], p["slabs"]) == (132, 8, 128 * 96)
    # o at 2 bits has 1024 slabs: 7 warps a CTA keep all 132 SMs busy
    p = K._w4a8_stream_plan(8, 4096, 4096, 2)
    assert (p["ctas"], p["warps"]) == (132, 7)
    # a smaller grid on request, never one with a warp and no slab
    assert K._w4a8_stream_plan(8, 96, 256, 4, 132, 2)["ctas"] == 2
    assert K._w4a8_stream_plan(8, 96, 256, 4, 132, 5)["ctas"] == 3
    assert K._w4a8_stream_plan(8, 4096, 4096, 4, 132, 7)["ctas"] == 7
