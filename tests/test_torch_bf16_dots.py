"""PyTorch port: the decode kernels' ``dots="bf16"`` mode (staged, inline,
all-batch and paged functions of ``ops/attention.py``), the fused and paged
decode steps with ``attn_dots="bf16"``, and all-batch blocks over 256
tokens, against the JAX reference on the CPU (Pallas kernels in interpret
mode).

Inputs are made with numpy from seeds and handed to both packages; the
steps go through the rounding replay of ``tests/test_torch_fused.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.ops import attention as JA
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as TA

import test_torch_paged as TP
from test_torch_attention import POS, POS_AB, POS_INLINE, _inputs, _jax
from test_torch_fused import (  # noqa: F401 (a fixture)
    _loop_over_seeds, _one_torch_thread)
from test_torch_paged import fused_state  # noqa: F401 (a fixture)

# the JAX suite's own kernel-vs-twin bound (tests/test_flash_attention.py).
# In bf16 both sides round the same f32 q and p * v_scale to bf16 (an exp
# one ulp apart could move one p * v_scale to its other bf16 neighbour; no
# such flip was read) and sum exact products in f32.
RTOL, ATOL = 2e-5, 2e-6

_ARGS = ("q", "k", "v", "ks", "vs", "k_new", "v_new")


def _t(inp, names=_ARGS):
    return [torch.from_numpy(inp[n]) for n in names]


class TestBf16DecodeKernels:
    @pytest.mark.parametrize("G", [1, 2])
    def test_staged(self, G):
        inp = _inputs(110 + G, L=2, B=len(POS), KVH=2, G=G, D=32, T=64,
                      pos=POS)
        out = TA.flash_decode_q8_staged(*_t(inp), 1,
                                        torch.from_numpy(inp["pos"]),
                                        block_t=32, dots="bf16")
        ref = _jax(JA.flash_decode_q8_staged, inp, 1, block_t=32,
                   interpret=True, dots="bf16")
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
        # the rounding is real: f32 dots give another answer
        f32 = TA.flash_decode_q8_staged(*_t(inp), 1,
                                        torch.from_numpy(inp["pos"]),
                                        block_t=32, dots="f32")
        assert float((out - f32).abs().max()) > 1e-4

    @pytest.mark.parametrize("G", [1, 2])
    def test_inline(self, G):
        inp = _inputs(120 + G, L=2, B=len(POS_INLINE), KVH=2, G=G, D=32,
                      T=64, pos=POS_INLINE)
        out = TA.flash_decode_q8(*_t(inp, _ARGS[:5]), 1,
                                 torch.from_numpy(inp["pos"]), block_t=32,
                                 dots="bf16")
        j = [jnp.asarray(inp[n]) for n in _ARGS[:5]]
        ref = np.asarray(JA.flash_decode_q8(
            *j, jnp.asarray(1, jnp.int32), jnp.asarray(inp["pos"]),
            block_t=32, interpret=True, dots="bf16"))
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("staged", [True, False])
    def test_all_batch(self, staged):
        inp = _inputs(130 + staged, L=2, B=len(POS_AB), KVH=2, G=2, D=32,
                      T=256, pos=POS_AB)
        out = TA.flash_decode_q8_ab(*_t(inp), 1, torch.from_numpy(inp["pos"]),
                                    staged=staged, dots="bf16")
        ref = _jax(JA.flash_decode_q8_ab, inp, 1, staged=staged,
                   interpret=True, dots="bf16")
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)

    def test_paged(self):
        inp = TP._kernel_inputs(140, pos=(32, 64, 33))
        out = TP._port_paged(inp, 1, dots="bf16")
        ref = TP._jax_paged(inp, 1, interpret=True, dots="bf16")
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
    def test_all_batch_block_over_256(self, dots):
        # T % 128 != 0: the all-batch partition is one block of the whole
        # T, which the reference serves and the CUDA kernel walks in
        # sub-tiles; in i8 the block is one quantization group of p * vs
        T = 320
        inp = _inputs(150, L=1, B=3, KVH=2, G=2, D=32, T=T,
                      pos=[0, 200, T])
        assert TA._ab_blocks(3, 2, 32, T, 64)[1] == T
        out = TA.flash_decode_q8_ab(*_t(inp), 0, torch.from_numpy(inp["pos"]),
                                    staged=True, dots=dots)
        ref = _jax(JA.flash_decode_q8_ab, inp, 0, staged=True,
                   interpret=True, dots=dots)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


class TestBf16DecodeSteps:
    @pytest.mark.parametrize("flags", [
        dict(staged_kv="uniform"), dict(staged_kv=False),
        dict(staged_kv=True, attn_kernel="ab")])
    def test_fused_step_matches_reference(self, flags):
        # each step from the reference's cache, the int8 codes of the glue
        # replayed, then the tight bound
        _loop_over_seeds("tiny", range(2), "bf16", steps=4, **flags)

    def test_paged_step_matches_reference(self, fused_state):
        TP.TestPagedFusedStep().test_decode_matches_reference(fused_state,
                                                              "bf16")
