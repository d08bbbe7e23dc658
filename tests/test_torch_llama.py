"""PyTorch port, ``models/llama.py``: the output head, the plain attention
the reference leaves to XLA, and the KV caches, against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.models import llama as JL
from ee274_convexcaldera_llm_quantization_tpu.models.config import TINY
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    config as TC)

# the fused path's logits bound (tests/test_torch_fused.py)
LOGIT_RTOL, LOGIT_ATOL = 2e-4, 2e-5


class TestTiedHead:
    def test_f32_embedding_rounds_to_bf16(self):
        # A tied head is a bf16 dot in the reference: the f32 embedding is
        # rounded to bf16 first. Multiplying by the f32 embedding instead
        # read 1.7e-3 relative (1.3e-3 max abs) here, 8.6x the bound.
        rng = np.random.default_rng(3)
        h = TINY.hidden_size
        x = rng.normal(size=(3, h)).astype(np.float32)
        embed = (rng.normal(size=(TINY.vocab_size, h)) * 0.02).astype(
            np.float32)
        norm = rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32)
        ref = np.asarray(JL._logits(
            jnp.asarray(x), JL.ModelParams(jnp.asarray(embed), [],
                                           jnp.asarray(norm), None),
            TINY, False, False))
        out = TL._logits(torch.from_numpy(x), torch.from_numpy(embed),
                         torch.from_numpy(norm), None, TC.TINY)
        np.testing.assert_allclose(out.numpy(), ref, rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)


def _qkv(seed, B, S, T, KVH, G, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, KVH * G, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KVH, D)).astype(np.float32)
    valid = np.arange(T)[None, :] <= (T - S + np.arange(S))[:, None]
    mask = np.where(valid, 0.0, -1e30).astype(np.float32)[None, None, None]
    return q, k, v, mask


class TestPlainAttention:
    @pytest.mark.parametrize("G", [1, 2])
    def test_attention_matches_reference(self, G):
        q, k, v, mask = _qkv(10 + G, 2, 5, 12, 2, G, 32)
        ref = np.asarray(JL._attention(*map(jnp.asarray, (q, k, v, mask))))
        out = TL._attention(*map(torch.from_numpy, (q, k, v, mask)))
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-6)

    @pytest.mark.parametrize("G", [1, 2])
    def test_attention_q8_matches_reference(self, G):
        q, _, _, mask = _qkv(20 + G, 2, 5, 12, 2, G, 32)
        rng = np.random.default_rng(30 + G)
        k = rng.integers(-127, 128, size=(2, 12, 2, 32), dtype=np.int8)
        v = rng.integers(-127, 128, size=(2, 12, 2, 32), dtype=np.int8)
        ks = rng.uniform(0.001, 0.02, size=(2, 12, 2)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=(2, 12, 2)).astype(np.float32)
        args = (q, k, v, ks, vs, mask)
        ref = np.asarray(JL._attention_q8(*map(jnp.asarray, args)))
        out = TL._attention_q8(*map(torch.from_numpy, args))
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-6)


class TestCaches:
    @pytest.mark.parametrize("name", ["KVCache", "QuantKVCache",
                                      "HeadMajorQuantKVCache"])
    def test_shapes_and_types_match_reference(self, name):
        jc = getattr(JL, name).create(TINY, 3, 16)
        tc = getattr(TL, name).create(TC.TINY, 3, 16, device="cpu")
        for f, a in zip(jc._fields, jc):
            t = getattr(tc, f)
            assert tuple(t.shape) == a.shape, f
            assert str(t.dtype).split(".")[-1] == a.dtype.name, f
            assert not bool(t.float().abs().sum())

    def test_create_defaults_to_the_card(self):
        if torch.cuda.is_available():
            assert TL.QuantKVCache.create(TC.TINY, 1, 8).k.is_cuda
            return
        for cls in (TL.KVCache, TL.QuantKVCache):
            with pytest.raises(RuntimeError, match="cuda"):
                cls.create(TC.TINY, 1, 8)
