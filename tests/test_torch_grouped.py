"""PyTorch port, ``ops/kernels.py`` grouped and flat packed matmuls and
``models/compressed.py``: packing, the grouped (bf16) and flat W4A8
matmuls' plain versions, ``fused_qlr_matmul``, ``compress_linear`` and
``apply_linear`` in all three ``CalderaLinear`` branches, against the JAX
reference (Pallas kernels in interpret mode and their XLA twins).

Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.models import compressed as JC
from ee274_convexcaldera_llm_quantization_tpu.ops import kernels as JK
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    compressed as TC)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as TK

from test_torch_fused import _one_torch_thread  # noqa: F401 (a fixture)


def _rng(seed):
    return np.random.default_rng(seed)


def _packed(rng, shape, bits):
    # 8-bit offset-binary codes live in [0, 254] (ROADMAP R5)
    return rng.integers(0, 255 if bits == 8 else 256, size=shape,
                        dtype=np.uint8)


def _grouped_close(y, ref):
    # Every bf16 x bf16 product is exact in f32 on both sides; only the
    # order of the K f32 sums differs (K <= 512 here), a few f32 ulps of the
    # largest partial sum: rtol 1e-5 and atol 1e-5 of the largest output.
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _int_close(y, ref):
    # i32 sums are exact on both sides; only the f32 rescale may round
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def _scales_close(t, j):
    # XLA may divide by the constant maxq as a multiplication by its
    # reciprocal: one f32 ulp, at most 2^-23 relative
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.0 ** -23)


def _bf16_np(t):
    return t.float().numpy()


class TestPackForServing:
    @pytest.mark.parametrize("bits,K,group", [
        (2, 256, None), (4, 256, None), (8, 256, None), (4, 384, 32),
        (2, 512, 16), (8, 96, 32)])
    def test_bytes_and_dequant_equal(self, bits, K, group):
        W = _rng(bits * 100 + K).normal(size=(48, K)).astype(np.float32)
        W[3, :40] = 0.0                       # an all-zero group: absmax floor
        packed, scales = TK.pack_for_serving(torch.from_numpy(W), bits, group)
        jp, js = JK.pack_for_serving(jnp.asarray(W), bits, group)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
        _scales_close(scales, js)
        G = TK.resolve_group(bits, K, group)
        deq = TK.dequant_serving_xla(packed, torch.from_numpy(np.array(js)),
                                     bits, group)
        jdeq = JK.dequant_serving_xla(jp, js, bits, G)
        assert deq.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bf16_np(deq),
                                      np.asarray(jdeq, np.float32))

    def test_resolve_block_n(self):
        for bn, bits in [(None, 2), (None, 4), (None, 8), (128, 4)]:
            assert TK.resolve_block_n(bn, bits) == JK.resolve_block_n(bn,
                                                                      bits)
        # down_proj at 4 bits: K/f = 5504 = 43 * 128, so G is 128, not 512
        assert TK.resolve_group(4, 11008, None) == 128


class TestQuantizedMatmul:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    @pytest.mark.parametrize("M", [1, 5, 40])
    def test_matches_pallas_and_xla(self, bits, M):
        rng = _rng(10 * bits + M)
        N, K = 96, 256
        f = 8 // bits
        G = TK.resolve_group(bits, K, None)
        x = rng.normal(size=(M, K)).astype(np.float32)
        packed = _packed(rng, (N, K // f), bits)
        scales = rng.uniform(0.001, 0.02, size=(N, K // G)).astype(np.float32)
        y = TK.quantized_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                                torch.from_numpy(scales), bits)
        args = (jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                bits)
        _grouped_close(y.numpy(), JK.quantized_matmul(*args, interpret=True))
        _grouped_close(y.numpy(), JK.quantized_matmul_xla(*args))

    @pytest.mark.parametrize("bits,group", [(2, 16), (4, 32), (8, 64)])
    def test_explicit_group(self, bits, group):
        rng = _rng(bits + group)
        M, N, K = 5, 64, 512
        f = 8 // bits
        x = rng.normal(size=(M, K)).astype(np.float32)
        packed = _packed(rng, (N, K // f), bits)
        scales = rng.uniform(0.001, 0.02,
                             size=(N, K // group)).astype(np.float32)
        y = TK.quantized_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                                torch.from_numpy(scales), bits, group)
        ref = JK.quantized_matmul(jnp.asarray(x), jnp.asarray(packed),
                                  jnp.asarray(scales), bits, group,
                                  interpret=True)
        _grouped_close(y.numpy(), ref)

    def test_input_rules(self):
        x = torch.zeros(2, 64)
        with pytest.raises(TypeError, match="uint8"):
            TK.quantized_matmul(x, torch.zeros(8, 32, dtype=torch.int8),
                                torch.ones(8, 1), 4)
        with pytest.raises(ValueError, match="shape mismatch"):
            TK.quantized_matmul(x, torch.zeros(8, 32, dtype=torch.uint8),
                                torch.ones(8, 3), 4)
        with pytest.raises(ValueError, match="divide"):
            TK.quantized_matmul(x, torch.zeros(8, 32, dtype=torch.uint8),
                                torch.ones(8, 2), 4, 24)


class TestW4A8Flat:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    @pytest.mark.parametrize("M", [1, 33])
    def test_matches_pallas(self, bits, M):
        rng = _rng(300 + 10 * bits + M)
        N, K = 128, 256
        f = 8 // bits
        x = rng.normal(size=(M, K)).astype(np.float32)
        packed = _packed(rng, (N, K // f), bits)
        scales = rng.uniform(0.001, 0.02, size=(N, 1)).astype(np.float32)
        y = TK.quantized_matmul_w4a8(torch.from_numpy(x),
                                     torch.from_numpy(packed),
                                     torch.from_numpy(scales), bits)
        ref = JK.quantized_matmul_w4a8(jnp.asarray(x), jnp.asarray(packed),
                                       jnp.asarray(scales), bits,
                                       interpret=True)
        _int_close(y.numpy(), ref)
        _int_close(y.numpy(), JK.quantized_matmul_w4a8_xla(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), bits))

    def test_input_rules(self):
        x = torch.zeros(2, 64)
        with pytest.raises(TypeError, match="uint8"):
            TK.quantized_matmul_w4a8(x, torch.zeros(8, 32, dtype=torch.int8),
                                     torch.ones(8, 1), 4)
        with pytest.raises(ValueError, match="shape mismatch"):
            TK.quantized_matmul_w4a8(x, torch.zeros(8, 32, dtype=torch.uint8),
                                     torch.ones(8, 2), 4)


def _linear_inputs(seed, N=96, K=256, r=8):
    rng = _rng(seed)
    W = (rng.normal(size=(N, K)) * K ** -0.5).astype(np.float32)
    L = (rng.normal(size=(N, r)) * 0.05).astype(np.float32)
    R = (rng.normal(size=(r, K)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(N,)) * 0.1).astype(np.float32)
    x = rng.normal(size=(2, 3, K)).astype(np.float32)
    return W, L, R, b, x


def _both_linears(seed, mode, bits=4, int8_factors=False, group=None):
    """The reference's and the port's compress_linear of the same numpy
    (Q, L, R, bias), gs 0.9; int8 factors through quantize_factors_int8."""
    W, L, R, b, x = _linear_inputs(seed)
    j = JC.compress_linear(jnp.asarray(W), jnp.asarray(L), jnp.asarray(R),
                           bits, global_scale=0.9, group_size=group,
                           bias=jnp.asarray(b), mode=mode)
    t = TC.compress_linear(torch.from_numpy(W), torch.from_numpy(L),
                           torch.from_numpy(R), bits, global_scale=0.9,
                           group_size=group, bias=torch.from_numpy(b),
                           mode=mode)
    if int8_factors:
        j, t = JC.quantize_factors_int8(j), TC.quantize_factors_int8(t)
    return j, t, x


class TestCompressedLinear:
    @pytest.mark.parametrize("mode,bits,group", [
        ("grouped", 4, None), ("grouped", 2, 16), ("w4a8", 4, None),
        ("w4a8", 3, None), ("w4a8", 8, None)])
    def test_compress_linear_matches_reference(self, mode, bits, group):
        j, t, _ = _both_linears(5, mode, bits, group=group)
        for f in ("packed", "global_scale", "b"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), f)
        _scales_close(t.scales, j.scales)
        for f in ("L", "R"):
            assert getattr(t, f).dtype == torch.bfloat16
            np.testing.assert_array_equal(
                _bf16_np(getattr(t, f)),
                np.asarray(getattr(j, f), np.float32))
        for f in ("num_bits", "group_size", "out_features", "in_features",
                  "mode", "q_method", "grid_bits"):
            assert getattr(t, f) == getattr(j, f), f
        # the dense reconstruction: same bf16 weights and factors, f32
        # products summed over rank 8 in another order
        np.testing.assert_allclose(t.materialize().numpy(),
                                   np.asarray(j.materialize()), rtol=1e-6,
                                   atol=1e-7)

    def test_unported_quantizer_raises(self):
        W, L, R, _, _ = _linear_inputs(1)
        with pytest.raises(NotImplementedError, match="lattice"):
            TC.compress_linear(torch.from_numpy(W), torch.from_numpy(L),
                               torch.from_numpy(R), 4, mode="w4a8",
                               q_method="e8p")
        with pytest.raises(ValueError, match="w4a8"):
            TC.compress_linear(torch.from_numpy(W), torch.from_numpy(L),
                               torch.from_numpy(R), 3, mode="grouped")

    @pytest.mark.parametrize("mode,int8_factors", [
        ("w4a8", True), ("grouped", True), ("grouped", False)])
    def test_apply_linear_matches_pallas(self, mode, int8_factors):
        # the three branches of the reference's apply_linear (w4a8 kernel +
        # factor dots; grouped kernel + factor dots; fused_qlr_matmul), with
        # a bias and leading dimensions (2, 3)
        j, t, x = _both_linears(20 + int8_factors, mode,
                                int8_factors=int8_factors)
        ref = np.asarray(JC.apply_linear(j, jnp.asarray(x), use_pallas=True,
                                         interpret=True))
        twin = np.asarray(JC.apply_linear(j, jnp.asarray(x)))
        y = TC.apply_linear(t, torch.from_numpy(x)).numpy()
        assert y.shape == (2, 3, 96)
        # the packed product as above; the factor dots sum in f32 in
        # another order before their bf16 casts
        for r in (ref, twin):
            np.testing.assert_allclose(y, r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max())

    def test_fused_qlr_matmul(self):
        j, t, x = _both_linears(30, "grouped")
        x2 = x.reshape(-1, x.shape[-1])
        ref = JK.fused_qlr_matmul(jnp.asarray(x2), j.packed, j.scales, j.L,
                                  j.R, 4, j.group_size, 0.9, use_pallas=False)
        y = TK.fused_qlr_matmul(torch.from_numpy(x2), t.packed, t.scales, t.L,
                                t.R, 4, t.group_size, 0.9)
        _grouped_close(y.numpy(), ref)
