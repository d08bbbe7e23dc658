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
        inp = _inputs(32, L=1, B=1, KVH=1, G=1, D=32, T=32, pos=[3])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port(inp, 0, dots="bf16")
