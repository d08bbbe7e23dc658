"""PyTorch port, the two megakernels against the JAX reference (Pallas
kernels in interpret mode): the whole-MLP kernel
(``quantized_matmul_w4a8_mlp_stacked``) and the fused attention + o_proj
kernel (``flash_decode_attn_o``), their plain versions and their guards,
``decode_step_fused`` with ``mlp_kernel`` and ``attn_o_kernel``, and
``FastServingEngine(mlp_kernel=True)``.

Both kernels requantize inside (``m``, the attention output) to int8. The
rounding replay of ``tests/test_torch_fused.py`` records those codes on
both sides (the reference's from inside its kernel) and replays a knife-edge
flip with the reference's code before the tight bound."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.ops import attention as JA
from ee274_convexcaldera_llm_quantization_tpu.ops import kernels as JK
from ee274_convexcaldera_llm_quantization_tpu.serve import engine as JE
from ee274_convexcaldera_llm_quantization_tpu.serve import fast_engine as JFE
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as TA
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as TK
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import engine as TE
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
    fast_engine as TFE)

from test_torch_factor_paths import (
    FACTOR_LOGIT_REL, FACTOR_MAX_FLIPS, FACTOR_RATIO_TOL)
from test_torch_fused import (  # noqa: F401 (a fixture)
    _Rounding, _loop_over_seeds, _one_torch_thread, _params, _port_config,
    _replay)
from test_torch_serve import _requests, _serve

# One kernel call after the replay: the integer sums are exact; the factor
# dots sum in another f32 order, and bf16(m) / bf16(attn) before the R dot
# can round to the other neighbour (at most 1.37e-7 rel-Frobenius read).
KERNEL_REL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _mlp_weights(seed, L, h, im, rank, bits):
    """tests/test_mlp_megakernel.py's weights (8-bit codes in [0, 254]:
    ROADMAP R5)."""
    rng = np.random.default_rng(seed)
    f = 8 // bits
    hi = 255 if bits == 8 else 256
    u = rng.uniform
    return dict(
        gu_packed=rng.integers(0, hi, (L, 2 * im, h // f)).astype(np.uint8),
        gu_scales=u(1e-3, 1e-2, (L, 2 * im, 1)).astype(np.float32),
        gu_L=rng.integers(-127, 128, (L, 2 * im, rank)).astype(np.int8),
        gu_Ls=u(1e-4, 1e-3, (L, 2 * im, 1)).astype(np.float32),
        gu_R=rng.integers(-127, 128, (L, 2 * rank, h)).astype(np.int8),
        gu_Rs=u(1e-4, 1e-3, (L, 2 * rank, 1)).astype(np.float32),
        gu_gs=u(0.5, 2.0, (L, 2)).astype(np.float32),
        dn_packed=rng.integers(0, hi, (L, h, im // f)).astype(np.uint8),
        dn_scales=u(1e-3, 1e-2, (L, h, 1)).astype(np.float32),
        dn_R=rng.integers(-127, 128, (L, rank, im)).astype(np.int8),
        dn_Rs=u(1e-4, 1e-3, (L, rank, 1)).astype(np.float32),
        dn_L=rng.integers(-127, 128, (L, h, rank)).astype(np.int8),
        dn_Ls=u(1e-4, 1e-3, (L, h, 1)).astype(np.float32))


_MLP_ORDER = ("gu_packed", "gu_scales", "xr", "gu_L", "gu_Ls", "gu_gs",
              "dn_packed", "dn_scales", "dn_R", "dn_Rs", "dn_L", "dn_Ls")


@functools.partial(jax.jit, static_argnames=("layer", "num_bits", "rank"))
def _jax_mlp(x, w, layer, num_bits, rank):
    """The reference's call as ``fused._apply_mlp_mega`` makes it (the
    module attribute looked up at trace time, so the recorder's wrappers
    take part)."""
    xr = jnp.dot(x.astype(jnp.bfloat16),
                 w["gu_R"][layer].T.astype(jnp.bfloat16),
                 preferred_element_type=jnp.float32) \
        * w["gu_Rs"][layer][:, 0][None, :]
    args = dict(w, xr=xr)
    return JK.quantized_matmul_w4a8_mlp_stacked(
        x, args["gu_packed"], args["gu_scales"], jnp.asarray(layer),
        *(args[k] for k in _MLP_ORDER[2:]), num_bits=num_bits, rank=rank,
        interpret=True)


def _port_mlp(x, w, layer, num_bits, rank):
    tw = {k: _t(v) for k, v in w.items()}
    xr = TK.thin_xr(x, tw["gu_R"][layer], tw["gu_Rs"][layer])
    args = dict(tw, xr=xr)
    return TK.quantized_matmul_w4a8_mlp_stacked(
        x, args["gu_packed"], args["gu_scales"], layer,
        *(args[k] for k in _MLP_ORDER[2:]), num_bits, rank)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class TestMlpKernel:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    def test_matches_reference(self, bits):
        # tests/test_mlp_megakernel.py's shapes, both layers: each call
        # replayed at the flips of the x and m requantizations
        L, h, im, rank, M = 2, 128, 256, 128, 3
        w = _mlp_weights(0, L, h, im, rank, bits)
        x = np.random.default_rng(1).standard_normal((M, h)).astype(
            np.float32)
        with _Rounding(_jax_mlp, static=("layer", "num_bits", "rank")) as rec:
            for layer in range(L):
                ref, got, first, flips, ratio = _replay(
                    rec, lambda: rec.jax_step(
                        jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in w.items()},
                        layer=layer, num_bits=bits, rank=rank),
                    lambda: _port_mlp(_t(x), w, layer, bits, rank).numpy())
                ref = np.asarray(ref)
                assert got.shape == (M, h)
                assert _rel(got, ref) <= KERNEL_REL, _rel(got, ref)
                print(f"\nmlp {bits}-bit layer {layer}: {flips} codes "
                      f"replayed, {_rel(first, ref):.2e} before, "
                      f"{_rel(got, ref):.2e} after")

    def test_one_row_block(self):
        # the reference's contract: M > block_m (one 128-row block) raises
        w = _mlp_weights(2, 1, 128, 256, 128, 4)
        x = np.zeros((129, 128), np.float32)
        with pytest.raises(ValueError, match="one row block"):
            _jax_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                      w.items()}, layer=0, num_bits=4,
                     rank=128)
        with pytest.raises(ValueError, match="one row block"):
            _port_mlp(_t(x), w, 0, 4, 128)
        with pytest.raises(AssertionError, match="xr_gu"):
            TK.quantized_matmul_w4a8_mlp_stacked(
                _t(x[:3]), _t(w["gu_packed"]), _t(w["gu_scales"]), 0,
                torch.zeros(3, 128), *(_t(w[k]) for k in _MLP_ORDER[3:]), 4,
                128)


def _attn_inputs(seed, L, B, KVH, D, T, h, rank, bits):
    """tests/test_flash_attention.py::TestFusedAttnO's inputs, from numpy."""
    rng = np.random.default_rng(seed)
    qdim = KVH * D
    f = 8 // bits
    return dict(
        q=rng.standard_normal((B, KVH, 1, D)).astype(np.float32),
        k=rng.integers(-127, 128, (L, B, KVH, T, D)).astype(np.int8),
        v=rng.integers(-127, 128, (L, B, KVH, T, D)).astype(np.int8),
        ks=rng.uniform(1e-3, 2e-2, (L, B, KVH, T)).astype(np.float32),
        vs=rng.uniform(1e-3, 2e-2, (L, B, KVH, T)).astype(np.float32),
        kn=(rng.standard_normal((L, B, KVH, D)) * 0.1).astype(np.float32),
        vn=(rng.standard_normal((L, B, KVH, D)) * 0.1).astype(np.float32),
        ow=rng.integers(0, 256, (L, h, qdim // f)).astype(np.uint8),
        osc=rng.uniform(1e-3, 1e-2, (L, h, 1)).astype(np.float32),
        oR=rng.integers(-127, 128, (L, rank, qdim)).astype(np.int8),
        oRs=rng.uniform(1e-4, 1e-3, (L, rank, 1)).astype(np.float32),
        oL=rng.integers(-127, 128, (L, h, rank)).astype(np.int8),
        oLs=rng.uniform(1e-4, 1e-3, (L, h, 1)).astype(np.float32))


_ATTN_ORDER = ("q", "k", "v", "ks", "vs", "kn", "vn")
_O_ORDER = ("ow", "osc", "oR", "oRs", "oL", "oLs")


@functools.partial(jax.jit, static_argnames=("layer", "staged"))
def _jax_attn_o(inp, pos, layer, staged):
    return JA.flash_decode_attn_o(
        *(inp[k] for k in _ATTN_ORDER), jnp.asarray(layer), pos,
        *(inp[k] for k in _O_ORDER), num_bits=4, rank=128, staged=staged,
        block_t=32, interpret=True)


class TestAttnOKernel:
    @pytest.mark.parametrize("staged", [False, True])
    def test_matches_reference(self, staged):
        # three rows at ragged positions (one on the last token), both
        # layers; the staged rows add the current token's K/V
        inp = _attn_inputs(0, 2, 3, 4, 128, 64, 128, 128, 4)
        pos = np.asarray([5, 40, 63], np.int32)
        with _Rounding(_jax_attn_o, static=("layer", "staged")) as rec:
            for layer in range(2):
                ref, got, first, flips, _ = _replay(
                    rec, lambda: rec.jax_step(
                        {k: jnp.asarray(v) for k, v in inp.items()},
                        jnp.asarray(pos), layer=layer, staged=staged),
                    lambda: TA.flash_decode_attn_o(
                        *(_t(inp[k]) for k in _ATTN_ORDER), layer, _t(pos),
                        *(_t(inp[k]) for k in _O_ORDER), 4, 128,
                        staged=staged, block_t=32).numpy())
                ref = np.asarray(ref)
                assert got.shape == (3, 128)
                assert _rel(got, ref) <= KERNEL_REL, _rel(got, ref)
                print(f"\nattn_o staged={staged} layer {layer}: {flips} "
                      f"codes replayed, {_rel(first, ref):.2e} before, "
                      f"{_rel(got, ref):.2e} after")

    def test_guards(self):
        # the reference's ValueErrors: GQA, batch above 32
        inp = _attn_inputs(1, 1, 1, 2, 128, 32, 256, 128, 4)
        gqa = dict(inp, q=np.zeros((1, 1, 2, 128), np.float32))
        for bad, match in ((gqa, "MHA"), (dict(inp, q=np.zeros(
                (33, 2, 1, 128), np.float32)), "batch")):
            with pytest.raises(ValueError, match=match):
                TA.flash_decode_attn_o(
                    *(_t(bad[k]) for k in _ATTN_ORDER), 0,
                    torch.tensor([3], dtype=torch.int32),
                    *(_t(bad[k]) for k in _O_ORDER), 4, 128)
        with pytest.raises(ValueError, match="MHA"):
            _jax_attn_o({k: jnp.asarray(v) for k, v in gqa.items()},
                        jnp.asarray([3], jnp.int32), layer=0, staged=False)
        assert TA.attn_o_supported(32, 1, 128, 4096, 128)
        for args in ((8, 4, 128, 4096, 128), (32, 1, 64, 4096, 128),
                     (32, 1, 128, 4096, 64), (32, 1, 128, 96, 128)):
            assert TA.attn_o_supported(*args) == JA.attn_o_supported(*args)


class TestMegakernelSteps:
    @pytest.mark.parametrize("name,kw", [
        # TINY is GQA: the MLP kernel only (its gate/up group takes L_cat)
        ("tiny-l", dict(staged_kv="uniform", mlp_kernel=True)),
        ("tiny-mha-l", dict(staged_kv="uniform", mlp_kernel=True)),
        ("mha512-l", dict(staged_kv=True, attn_o_kernel=True,
                          mlp_kernel=True)),
        ("mha512-l", dict(staged_kv=False, attn_o_kernel=True))])
    def test_decode_matches_reference(self, name, kw):
        # the reference step with the same flags, two seeded prompts of six
        # greedy steps; attn_o takes f32 dots only, the MLP kernel i8
        dots = "f32" if kw.get("attn_o_kernel") else "i8"
        _loop_over_seeds(name, range(2), dots, ratio_tol=FACTOR_RATIO_TOL,
                         max_flips=FACTOR_MAX_FLIPS,
                         logit_rel=FACTOR_LOGIT_REL, **kw)

    def test_fast_engine_matches_reference(self):
        # FastServingEngine(mlp_kernel=True) on "l" params: three short
        # greedy requests over two slots, the whole runs replayed at the
        # roundings, then equal completions
        config, jparams, tparams = _params("tiny-l")
        reqs = _requests(5, config.vocab_size, n=3, new_tokens=4)
        kw = dict(max_slots=2, max_seq_len=32, flash_attn=True,
                  mlp_kernel=True)
        with _Rounding() as rec:
            ref, got, first, flips, _ = _replay(
                rec, lambda: _serve(JFE.FastServingEngine(
                    jparams, config, interpret=True, **kw), reqs,
                    JE.Request),
                lambda: _serve(TFE.FastServingEngine(
                    tparams, _port_config(config), device="cpu", **kw),
                    reqs, TE.Request),
                FACTOR_MAX_FLIPS, FACTOR_RATIO_TOL)
        print(f"\nengine mlp_kernel: {flips} codes replayed; completions "
              f"before the replay {'equal' if first == ref else 'differ'}")
        assert len(ref) == len(reqs)
        assert got == ref

    def test_fast_engine_rejects_xla_params(self):
        # the reference's engine passes mlp_kernel to the step, whose guard
        # refuses params without the fused-factor layout
        _, _, tparams = _params("tiny")
        cfg = _port_config(_params("tiny")[0])
        eng = TFE.FastServingEngine(tparams, cfg, max_slots=1,
                                    max_seq_len=16, flash_attn=True,
                                    mlp_kernel=True, device="cpu")
        eng.submit(TE.Request(uid=0, prompt=np.arange(1, 5),
                              max_new_tokens=2))
        with pytest.raises(ValueError, match="mlp_kernel"):
            eng.run()
