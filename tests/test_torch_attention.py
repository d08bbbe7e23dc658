"""PyTorch port, ``ops/attention.py``: staged flash-decode attention against
the JAX Pallas kernel in interpret mode and its XLA twin.

Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.ops import attention as JA
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as TA

# the JAX suite's own kernel-vs-twin bound (tests/test_flash_attention.py)
RTOL, ATOL = 2e-5, 2e-6


def _inputs(seed, L, B, KVH, G, D, T, pos, stacked_new=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KVH, G, D)).astype(np.float32)
    k = rng.integers(-127, 128, size=(L, B, KVH, T, D), dtype=np.int8)
    v = rng.integers(-127, 128, size=(L, B, KVH, T, D), dtype=np.int8)
    ks = rng.uniform(0.001, 0.02, size=(L, B, KVH, T)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, size=(L, B, KVH, T)).astype(np.float32)
    new_shape = (L, B, KVH, D) if stacked_new else (B, KVH, D)
    kn = (rng.normal(size=new_shape) * 0.5).astype(np.float32)
    vn = (rng.normal(size=new_shape) * 0.5).astype(np.float32)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, k_new=kn, v_new=vn,
                pos=np.asarray(pos, np.int32))


def _port(inp, layer, **kw):
    t = {n: torch.from_numpy(a) for n, a in inp.items()}
    return TA.flash_decode_q8_staged(
        t["q"], t["k"], t["v"], t["ks"], t["vs"], t["k_new"], t["v_new"],
        layer, t["pos"], **kw)


def _jax(fn, inp, layer, **kw):
    j = {n: jnp.asarray(a) for n, a in inp.items()}
    return np.asarray(fn(j["q"], j["k"], j["v"], j["ks"], j["vs"],
                         j["k_new"], j["v_new"], jnp.asarray(layer, jnp.int32),
                         j["pos"], **kw))


# pos 0 (no cache token), 1, a block edge (32), just past it (33), a
# multi-block row (50) and a full cache (64), at block_t 32 and T 64
POS = [0, 1, 32, 33, 50, 64]


class TestStagedFlashDecode:
    @pytest.mark.parametrize("dots", ["i8", "f32"])
    @pytest.mark.parametrize("G", [1, 2])
    def test_matches_pallas_interpret(self, dots, G):
        inp = _inputs(10 + G, L=2, B=len(POS), KVH=2, G=G, D=32, T=64,
                      pos=POS)
        out = _port(inp, 1, block_t=32, dots=dots)
        ref = _jax(JA.flash_decode_q8_staged, inp, 1, block_t=32,
                   interpret=True, dots=dots)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("G", [1, 2])
    def test_f32_matches_xla_twin(self, G):
        inp = _inputs(20 + G, L=2, B=len(POS), KVH=2, G=G, D=32, T=64,
                      pos=POS)
        out = _port(inp, 0, block_t=32, dots="f32")
        ref = _jax(JA.flash_decode_q8_staged_xla, inp, 0)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
        twin = TA.flash_decode_q8_staged_xla(
            *[torch.from_numpy(inp[n]) for n in
              ("q", "k", "v", "ks", "vs", "k_new", "v_new")], 0,
            torch.from_numpy(inp["pos"]))
        np.testing.assert_allclose(twin.numpy(), ref, rtol=RTOL, atol=ATOL)

    def test_layer_stacked_new_kv(self):
        inp = _inputs(30, L=3, B=3, KVH=2, G=2, D=32, T=64, pos=[5, 40, 0],
                      stacked_new=True)
        out = _port(inp, 2, block_t=32, dots="i8")
        ref = _jax(JA.flash_decode_q8_staged, inp, 2, block_t=32,
                   interpret=True, dots="i8")
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)

    def test_pos_zero_is_the_staged_value(self):
        inp = _inputs(31, L=1, B=1, KVH=2, G=2, D=32, T=64, pos=[0])
        out = _port(inp, 0, block_t=32, dots="i8").numpy()
        expect = np.broadcast_to(inp["v_new"][:, :, None, :], out.shape)
        np.testing.assert_allclose(out, expect, rtol=1e-6)

    def test_block_resolution(self):
        assert TA.resolve_block_t(256, 64) == 64
        assert TA.resolve_block_t(32, 48) == 16
        assert TA.resolve_block_t(256, 2048) == 256

    def test_bf16_dots_not_ported(self):
        # the name is kept from when dots="bf16" raised; it is ported now
        # and matches the reference's bf16 kernel on the same inputs
        inp = _inputs(32, L=1, B=1, KVH=1, G=1, D=32, T=32, pos=[3])
        out = _port(inp, 0, dots="bf16")
        ref = _jax(JA.flash_decode_q8_staged, inp, 0, interpret=True,
                   dots="bf16")
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def _port_inline(inp, layer, **kw):
    t = {n: torch.from_numpy(a) for n, a in inp.items()}
    return TA.flash_decode_q8(t["q"], t["k"], t["v"], t["ks"], t["vs"], layer,
                              t["pos"], **kw)


def _jax_inline(fn, inp, layer, **kw):
    j = {n: jnp.asarray(a) for n, a in inp.items()}
    return np.asarray(fn(j["q"], j["k"], j["v"], j["ks"], j["vs"],
                         jnp.asarray(layer, jnp.int32), j["pos"], **kw))


# inline: pos is the current token's column; 0, a block's last token (31),
# the next block's first (32), mid-block and the last column (63)
POS_INLINE = [0, 31, 32, 45, 50, 63]


class TestInlineFlashDecode:
    @pytest.mark.parametrize("dots", ["i8", "f32"])
    @pytest.mark.parametrize("G", [1, 2])
    def test_matches_pallas_interpret(self, dots, G):
        inp = _inputs(40 + G, L=2, B=len(POS_INLINE), KVH=2, G=G, D=32, T=64,
                      pos=POS_INLINE)
        out = _port_inline(inp, 1, block_t=32, dots=dots)
        ref = _jax_inline(JA.flash_decode_q8, inp, 1, block_t=32,
                          interpret=True, dots=dots)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("G", [1, 2])
    def test_f32_matches_xla_twin(self, G):
        inp = _inputs(50 + G, L=2, B=len(POS_INLINE), KVH=2, G=G, D=32, T=64,
                      pos=POS_INLINE)
        out = _port_inline(inp, 0, block_t=32, dots="f32")
        ref = _jax_inline(JA.flash_decode_q8_xla, inp, 0)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
        twin = TA.flash_decode_q8_xla(
            *[torch.from_numpy(inp[n]) for n in ("q", "k", "v", "ks", "vs")],
            0, torch.from_numpy(inp["pos"]))
        np.testing.assert_allclose(twin.numpy(), ref, rtol=RTOL, atol=ATOL)

    def test_pos_zero_attends_token_zero(self):
        inp = _inputs(52, L=1, B=1, KVH=2, G=2, D=32, T=64, pos=[0])
        out = _port_inline(inp, 0, block_t=32, dots="f32").numpy()
        v0 = inp["v"][0, 0, :, 0].astype(np.float32) * inp["vs"][0, 0, :, 0,
                                                                 None]
        np.testing.assert_allclose(out[0], np.broadcast_to(
            v0[:, None, :], out[0].shape), rtol=1e-6)


# ragged rows of the all-batch kernel at T 256 (two 128-token blocks): 0,
# block edges, the second block, and T (the whole cache)
POS_AB = [0, 1, 127, 128, 129, 200, 255, 256]


class TestAllBatchFlashDecode:
    @pytest.mark.parametrize("staged", [True, False])
    @pytest.mark.parametrize("dots", ["i8", "f32"])
    @pytest.mark.parametrize("G", [1, 2])
    def test_matches_pallas_interpret(self, staged, dots, G):
        inp = _inputs(60 + G + 2 * staged, L=2, B=len(POS_AB), KVH=2, G=G,
                      D=32, T=256, pos=POS_AB)
        # i8 too at the f32 bound: the plain version and the reference round
        # the same q and p * v_scale codes on the CPU (no flip was read)
        out = TA.flash_decode_q8_ab(
            *[torch.from_numpy(inp[n]) for n in
              ("q", "k", "v", "ks", "vs", "k_new", "v_new")], 1,
            torch.from_numpy(inp["pos"]), staged=staged, dots=dots)
        ref = _jax(JA.flash_decode_q8_ab, inp, 1, staged=staged,
                   interpret=True, dots=dots)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("staged", [True, False])
    def test_equals_row_kernels_on_one_partition(self, staged):
        # at T = 256 the all-batch partition is 128-token blocks; the row
        # kernels given block_t 128 walk the same blocks, so in i8 the two
        # agree to f32 rounding (the i8 codes are per block)
        inp = _inputs(70 + staged, L=1, B=len(POS_AB), KVH=2, G=2, D=32,
                      T=256, pos=POS_AB)
        t = [torch.from_numpy(inp[n]) for n in
             ("q", "k", "v", "ks", "vs", "k_new", "v_new")]
        pos = torch.from_numpy(inp["pos"])
        ab = TA.flash_decode_q8_ab(*t, 0, pos, staged=staged, dots="i8")
        if staged:
            row = TA.flash_decode_q8_staged(*t, 0, pos, block_t=128,
                                            dots="i8")
        else:
            row = TA.flash_decode_q8(*t[:5], 0, pos, block_t=128, dots="i8")
        np.testing.assert_allclose(ab.numpy(), row.numpy(), rtol=RTOL,
                                   atol=ATOL)

    def test_inline_takes_no_staged_kv(self):
        inp = _inputs(72, L=1, B=2, KVH=2, G=1, D=32, T=128, pos=[3, 90])
        t = [torch.from_numpy(inp[n]) for n in ("q", "k", "v", "ks", "vs")]
        pos = torch.from_numpy(inp["pos"])
        out = TA.flash_decode_q8_ab(*t, None, None, 0, pos, dots="f32")
        ref = TA.flash_decode_q8_xla(*t, 0, pos)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL,
                                   atol=ATOL)
        with pytest.raises(ValueError, match="staged"):
            TA.flash_decode_q8_ab(*t, None, None, 0, pos, staged=True)

    def test_block_partition_matches_reference(self):
        for B in (1, 2, 3, 8, 16):
            for KVH in (1, 2, 8, 32):
                for D in (32, 64, 128):
                    for T in (16, 100, 128, 200, 256, 384, 1024, 4096):
                        for cap in (64, 256):
                            assert (TA._ab_blocks(B, KVH, D, T, cap)
                                    == JA._ab_blocks(B, KVH, D, T, cap)), (
                                        B, KVH, D, T, cap)
        # the serving shape: Llama-2-7B at batch 8 and T 4096 takes
        # 128-token blocks, not the row kernel's 256
        assert TA._ab_blocks(8, 32, 128, 4096, 64)[1] == 128


def _causal_inputs(seed, B, S, KVH, G, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, KVH * G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KVH, D)).astype(np.float32)
    return q, k, v


class TestFlashPrefill:
    # the reference suite's shapes (tests/test_flash_attention.py), its
    # block sizes given to the reference only, plus a ragged S = 40
    @pytest.mark.parametrize("B,KVH,G,D,S,bq,bk", [
        (2, 2, 1, 32, 64, 16, 16),
        (1, 2, 2, 32, 64, 32, 16),
        (1, 1, 4, 128, 128, 128, 128),
        (2, 1, 2, 32, 48, 16, 32),
        (1, 2, 2, 32, 40, 16, 32),
    ])
    def test_matches_pallas_interpret(self, B, KVH, G, D, S, bq, bk):
        q, k, v = _causal_inputs(80 + S + G, B, S, KVH, G, D)
        out = TA.flash_prefill(*map(torch.from_numpy, (q, k, v)))
        ref = np.asarray(JA.flash_prefill(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=bq,
            block_k=bk, interpret=True))
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)

    def test_first_token_attends_only_itself(self):
        q, k, v = _causal_inputs(90, 1, 24, 2, 2, 32)
        out = TA.flash_prefill(*map(torch.from_numpy, (q, k, v))).numpy()
        np.testing.assert_allclose(out[0, 0], np.repeat(v[0, 0], 2, axis=0),
                                   rtol=1e-6)

    def test_rejects_mismatched_shapes(self):
        q, k, v = _causal_inputs(91, 1, 8, 2, 2, 32)
        with pytest.raises(ValueError, match="shape"):
            TA.flash_prefill(torch.from_numpy(q), torch.from_numpy(k[:, :4]),
                             torch.from_numpy(v[:, :4]))
