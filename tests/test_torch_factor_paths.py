"""PyTorch port, the fused step's factor paths "l" and "lr" against the JAX
reference (Pallas kernels in interpret mode): the L-fused and LR-fused
stacked W4A8 kernels' plain versions, the gates that decide whether
``L_cat`` is built and its bytes, decode steps, prefill and chunked prefill,
one paged fused step, and the ``interop`` round trip.

Inputs are made with numpy from seeds; params come from the reference's
``bench.build_compressed_llama_params`` at rank 128, fused and int8-factored
by the reference with ``fuse_factor_kernel`` "l" or "lr". Steps go through
the rounding replay of ``tests/test_torch_fused.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ee274_convexcaldera_llm_quantization_tpu.models import fused as JF
from ee274_convexcaldera_llm_quantization_tpu.models.config import (
    TINY, TINY_MHA)
from ee274_convexcaldera_llm_quantization_tpu.ops import kernels as JK
from ee274_convexcaldera_llm_quantization_tpu.serve import paged as JP
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    compressed as TCm)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused as TF
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    stacked as TS)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as TK
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import paged as TP

from test_torch_fused import (  # noqa: F401 (a fixture)
    FLIP_LOGIT_REL, _CACHES, _Rounding, _assert_caches_match, _flatten,
    _loop_over_seeds, _one_torch_thread, _params, _port_config, _rel,
    _replay, _reset, _torch_array)

# Kernel parity: the integer sums are exact on both sides; the 128-term
# factor dots and the f32 epilogue sum in another order (f32 ulps; 7.6e-6
# read at outputs of ~90 on the multi-projection case).
KERNEL_RTOL, KERNEL_ATOL_REL = 1e-5, 1e-6
# lr computes xr from bf16(x) @ R inside: its f32 sums in another order can
# round an xr element to the other bf16 neighbour before the L dot.
LR_RTOL, LR_ATOL_REL = 1e-4, 1e-5
# Steps at rank 128: besides the int8 roundings that the replay covers, the
# bf16 casts before the factor dots (y and xr; m in the MLP) sit on rounding
# edges of their own, which the replay does not cover. One such bf16 flip
# moved a later activation by up to 9.7e-2 of a code before its int8
# rounding (tiny-mha "l"), cascaded to at most 24 replayed codes in a step,
# and left at most 1.65e-4 rel-Frobenius on the logits after the replay.
FACTOR_RATIO_TOL = 0.15
FACTOR_MAX_FLIPS = 64
FACTOR_LOGIT_REL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _group(seed, layers, splits, K, rank, bits, rows=8):
    """Stacked packed codes (8-bit codes in [0, 254]: ROADMAP R5), row
    scales, int8 R / L factor codes and their scales, and ``rows`` rows of
    activations."""
    rng = np.random.default_rng(seed)
    f = 8 // bits
    N, nR = sum(splits), len(splits) * rank
    hi = 255 if bits == 8 else 256
    return dict(
        packed=rng.integers(0, hi, (layers, N, K // f)).astype(np.uint8),
        scales=rng.uniform(1e-3, 1e-2, (layers, N, 1)).astype(np.float32),
        R=rng.integers(-127, 128, (layers, nR, K)).astype(np.int8),
        Rs=rng.uniform(1e-4, 1e-3, (layers, nR, 1)).astype(np.float32),
        L=rng.integers(-127, 128, (layers, N, rank)).astype(np.int8),
        Ls=rng.uniform(1e-4, 1e-3, (layers, N, 1)).astype(np.float32),
        x=rng.standard_normal((rows, K)).astype(np.float32))


def _xr(g, layer, rows):
    """The reference's thin contraction, as ``_apply_fused`` computes it."""
    x = jnp.asarray(g["x"][:rows])
    xr = jnp.dot(x.astype(jnp.bfloat16),
                 jnp.asarray(g["R"][layer]).T.astype(jnp.bfloat16),
                 preferred_element_type=jnp.float32)
    return np.asarray(xr * jnp.asarray(g["Rs"][layer])[:, 0][None, :])


def _close(got, ref, rtol, atol_rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_rel * np.abs(ref).max())


class TestLowRankKernels:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    @pytest.mark.parametrize("splits,rank,rows", [
        ((512, 256, 256), 128, 8), ((512,), 24, 3), ((512, 256, 256), 128, 33),
        ((512,), 24, 130)])
    def test_l_matches_reference(self, splits, rank, rows, bits):
        # tests/test_kernels.py::TestLRStackedFused's shapes: a group of
        # three lane-aligned projections, and one projection of any rank; at
        # decode rows and above the tile path's threshold (the card's plan;
        # the CPU runs the plain version at every M)
        g = _group(2, 3, splits, 512, rank, bits, rows=max(rows, 8))
        xr = _xr(g, 1, rows)
        ref = JK.quantized_matmul_w4a8_l_stacked(
            jnp.asarray(g["x"][:rows]), jnp.asarray(g["packed"]),
            jnp.asarray(g["scales"]), jnp.asarray(1), jnp.asarray(xr),
            jnp.asarray(g["L"]), jnp.asarray(g["Ls"]), num_bits=bits,
            rank=rank, splits=splits, interpret=True)
        got = TK.quantized_matmul_w4a8_l_stacked(
            _t(g["x"][:rows]), _t(g["packed"]), _t(g["scales"]), 1, _t(xr),
            _t(g["L"]), _t(g["Ls"]), bits, rank, splits)
        _close(got.numpy(), ref, KERNEL_RTOL, KERNEL_ATOL_REL)

    def test_l_integer_part_is_exact(self):
        # with the factor codes zeroed the output is the exact integer sum
        # times the two scales: bit for bit the stacked W4A8 kernel's plain
        # version, and within one f32 rounding of the reference (which
        # multiplies the two scales in another association)
        g = _group(3, 2, (256, 256), 256, 128, 4)
        g["L"][:] = 0
        xr = _xr(g, 0, 8)
        ref = JK.quantized_matmul_w4a8_l_stacked(
            jnp.asarray(g["x"]), jnp.asarray(g["packed"]),
            jnp.asarray(g["scales"]), jnp.asarray(0), jnp.asarray(xr),
            jnp.asarray(g["L"]), jnp.asarray(g["Ls"]), num_bits=4, rank=128,
            splits=(256, 256), interpret=True)
        got = TK.quantized_matmul_w4a8_l_stacked(
            _t(g["x"]), _t(g["packed"]), _t(g["scales"]), 0, _t(xr),
            _t(g["L"]), _t(g["Ls"]), 4, 128, (256, 256))
        stacked = TK.quantized_matmul_w4a8_stacked(
            _t(g["x"]), _t(g["packed"]), _t(g["scales"]), 0, 4)
        assert torch.equal(got, stacked)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-7,
                                   atol=0)

    @pytest.mark.parametrize("bits", [4, 8])
    @pytest.mark.parametrize("splits,rank,rows", [
        ((512, 256, 256), 128, 8), ((512,), 24, 3), ((512, 256, 256), 128, 33),
        ((512,), 24, 130)])
    def test_lr_matches_reference(self, splits, rank, rows, bits):
        # at decode rows and above the tile path's threshold (the card's
        # plan; the CPU runs the plain version at every M)
        g = _group(4, 3, splits, 512, rank, bits, rows=max(rows, 8))
        ref = JK.quantized_matmul_w4a8_lr_stacked(
            jnp.asarray(g["x"][:rows]), jnp.asarray(g["packed"]),
            jnp.asarray(g["scales"]), jnp.asarray(2), jnp.asarray(g["R"]),
            jnp.asarray(g["Rs"]), jnp.asarray(g["L"]), jnp.asarray(g["Ls"]),
            num_bits=bits, rank=rank, splits=splits, interpret=True)
        got = TK.quantized_matmul_w4a8_lr_stacked(
            _t(g["x"][:rows]), _t(g["packed"]), _t(g["scales"]), 2,
            _t(g["R"]), _t(g["Rs"]), _t(g["L"]), _t(g["Ls"]), bits, rank,
            splits)
        _close(got.numpy(), ref, LR_RTOL, LR_ATOL_REL)

    def test_contracts(self):
        # the reference's asserts on splits and rank, and the layer range
        g = _group(5, 2, (256, 256), 256, 128, 4)
        args = [_t(g["x"]), _t(g["packed"]), _t(g["scales"]), 0,
                _t(_xr(g, 0, 8)), _t(g["L"]), _t(g["Ls"]), 4, 128]
        with pytest.raises(AssertionError, match="splits"):
            TK.quantized_matmul_w4a8_l_stacked(*args, (256, 128))
        with pytest.raises(AssertionError, match="xr"):
            TK.quantized_matmul_w4a8_l_stacked(*args[:-1], 64, (256, 256))
        with pytest.raises(AssertionError, match="R"):
            TK.quantized_matmul_w4a8_lr_stacked(
                _t(g["x"]), _t(g["packed"]), _t(g["scales"]), 0,
                _t(g["R"][:, :128]), _t(g["Rs"][:, :128]), _t(g["L"]),
                _t(g["Ls"]), 4, 128, (256, 256))
        args[3] = 2
        with pytest.raises(IndexError, match="layer"):
            TK.quantized_matmul_w4a8_l_stacked(*args, (256, 256))


GATE_CASES = [
    ((4096, 4096, 4096), (128, 128, 128), None, 4),
    ((4096, 4096), (128, 64), None, 4),
    ((512, 512, 512), (128, 128, 128), None, 4),
    ((128, 64, 64), (128, 128, 128), None, 4),
    ((256, 256), (128, 128), None, 2),
    ((384, 384), (128, 128), None, 4),
    ((640, 640), (128, 128), None, 2),
    ((11008, 11008), (128, 128), None, 4),
    ((768, 256), (64, 64), None, 4),
    ((512,), (24,), None, 4),
    ((96,), (16,), None, 4),
    ((1024, 1024), (128, 128), 128, 8),
    ((1536, 512, 512), (128, 128, 128), None, 2)]


class TestGatingAndLayout:
    def test_lr_gate_matches_reference(self):
        for splits, ranks, bn, bits in GATE_CASES:
            assert TK.lr_stacked_supported(splits, ranks, bn, bits) == \
                JK.lr_stacked_supported(splits, ranks, bn, bits), splits

    def test_mlp_gate_matches_reference(self):
        for im in (128, 256, 384, 11008, 13824, 64):
            for h in (128, 512, 4096, 5120, 96):
                for rank in (8, 64, 128, 256):
                    for bits in (2, 3, 4, 8):
                        assert TK.mlp_stacked_supported(im, h, rank, bits) \
                            == JK.mlp_stacked_supported(im, h, rank, bits)

    @pytest.mark.parametrize("config", [TINY, TINY_MHA])
    @pytest.mark.parametrize("fk", ["l", True])
    def test_quantize_builds_the_reference_layout(self, config, fk):
        # the port's fuse_stacked + quantize_factors_int8_fused on the
        # reference's unfused params give the reference's fused params byte
        # for byte: L_cat where the gate takes the group (TINY's qkv fails
        # it: its k/v splits of 64 rows), the per-projection layout and the
        # "xla" path elsewhere
        jp = bench.build_compressed_llama_params(config, num_bits=4,
                                                 rank=128, seed=0)
        ref = JF.quantize_factors_int8_fused(JF.fuse_stacked(jp),
                                             fuse_factor_kernel=fk)
        got = TF.quantize_factors_int8_fused(TF.fuse_stacked(
            _port_unfused(jp)), fuse_factor_kernel=fk)
        for name in ("qkv", "gateup"):
            a, b = getattr(got.layers, name), getattr(ref.layers, name)
            assert a.factor_kernel == b.factor_kernel, name
            assert (a.L_cat is None) == (b.L_cat is None), name
            assert len(a.Ls) == len(b.Ls), name
            for f in ("packed", "scales", "R", "R_scale", "L_cat",
                      "L_scale_cat"):
                if getattr(b, f) is not None:
                    np.testing.assert_array_equal(
                        getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                        err_msg=f"{name}.{f}")
            for x, y in zip(a.Ls + a.L_scales, b.Ls + b.L_scales):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        expect = "xla" if config is TINY else {True: "lr"}.get(fk, fk)
        assert got.layers.qkv.factor_kernel == expect
        for name in ("o_proj", "down_proj"):
            a, b = getattr(got.layers, name), getattr(ref.layers, name)
            for f in ("L", "L_scale", "R", "R_scale"):
                np.testing.assert_array_equal(getattr(a, f).numpy(),
                                              np.asarray(getattr(b, f)))

    @pytest.mark.parametrize("name", ["tiny-l", "tiny-mha-lr"])
    def test_interop_round_trip(self, name):
        # every array of the reference's fused params arrives bit for bit,
        # and the static fields (factor path, splits, ranks) with them
        _, jparams, tparams = _params(name)
        arrays, meta = {}, {}
        _flatten(jparams, "", arrays, meta)
        assert any(k.endswith("L_cat") for k in arrays)
        for key, a in arrays.items():
            t = _port_get(tparams, key)
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                else t.numpy(),
                a.view(np.int16) if a.dtype.name == "bfloat16" else a,
                err_msg=key)
        for key, v in meta.items():
            assert _port_get(tparams, key) == v, key


def _port_get(obj, key):
    for part in key.split("."):
        obj = obj[int(part)] if isinstance(obj, tuple) else getattr(obj,
                                                                    part)
    return obj


def _port_unfused(jp):
    """The reference's unfused stacked params as the port's (bf16 factors,
    bit for bit)."""
    def lin(j):
        return TCm.CalderaLinear(
            packed=_t(j.packed), scales=_t(j.scales),
            L=_torch_array(np.asarray(j.L)), R=_torch_array(np.asarray(j.R)),
            global_scale=_t(j.global_scale), num_bits=j.num_bits,
            group_size=j.group_size, out_features=j.out_features,
            in_features=j.in_features, mode=j.mode)
    lp = jp.layers
    layers = TS.LayerParams(
        attn_norm=_t(lp.attn_norm), mlp_norm=_t(lp.mlp_norm),
        **{n: lin(getattr(lp, n)) for n in (
            "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
            "down_proj")})
    return TS.StackedModelParams(
        embed=_torch_array(np.asarray(jp.embed)), layers=layers,
        final_norm=_t(jp.final_norm),
        lm_head=TCm.DenseLinear(w=_torch_array(np.asarray(jp.lm_head.w))))


class TestFactorPathSteps:
    @pytest.mark.parametrize("name", ["tiny-l", "tiny-lr", "tiny-mha-l",
                                      "tiny-mha-lr"])
    def test_decode_matches_reference(self, name):
        # the bench flow's step (staged "uniform", dots i8) on each factor
        # path, two seeded prompts of six greedy steps; on TINY only
        # gate/up take the fused-factor kernel
        _loop_over_seeds(name, range(2), "i8", staged_kv="uniform",
                         ratio_tol=FACTOR_RATIO_TOL,
                         max_flips=FACTOR_MAX_FLIPS,
                         logit_rel=FACTOR_LOGIT_REL)

    @pytest.mark.parametrize("fn", ["prefill", "chunks"])
    def test_prefill_matches_reference(self, fn):
        # a 13-token prompt in its 16-token bucket (flash prefill), or in
        # two 8-token chunks, on "l" params: every projection at M = S
        # through the L-fused kernel
        params = _params("tiny-mha-l")
        config = params[0]
        jcls, tcls = _CACHES["head"]
        prompt = np.random.default_rng(31).integers(
            0, config.vocab_size, 13).astype(np.int32)
        jcache = jcls.create(config, 2, 32)
        tcache = tcls.create(_port_config(config), 2, 32, device="cpu")
        if fn == "prefill":
            padded = np.zeros((1, 16), np.int32)
            padded[0, :13] = prompt
            calls = [(JF.prefill_into_slot_fused, TF.prefill_into_slot_fused,
                      ("config", "interpret", "flash"),
                      dict(tokens=padded, slot=1, last_pos=12),
                      dict(flash=True))]
        else:
            calls = []
            for off in (0, 8):
                chunk = np.zeros((1, 8), np.int32)
                chunk[0, :len(prompt[off:off + 8])] = prompt[off:off + 8]
                calls.append((JF.prefill_chunk_fused, TF.prefill_chunk_fused,
                              ("config", "interpret"),
                              dict(tokens=chunk, slot=1, offset=off,
                                   last_pos=12 - off if off else 0), {}))
        for jfn, tfn, static, args, extra in calls:
            with _Rounding(jfn, static=static) as rec:
                pre = [np.array(a) for a in jcache]

                def run_jax():
                    return rec.jax_step(
                        params[1], cache=jcache, config=config,
                        interpret=True, **extra,
                        **{k: jnp.asarray(v) for k, v in args.items()})

                def run_port():
                    _reset(tcache, pre)
                    return tfn(params[2], cache=tcache,
                               config=_port_config(config), **extra,
                               tokens=torch.from_numpy(
                                   args["tokens"].astype(np.int64)),
                               **{k: v for k, v in args.items()
                                  if k != "tokens"})[0].numpy()

                (jl, jcache), tl, first, flips, _ = _replay(
                    rec, run_jax, run_port, FACTOR_MAX_FLIPS,
                    FACTOR_RATIO_TOL)
            jl = np.asarray(jl)
            assert _rel(tl, jl) <= FACTOR_LOGIT_REL, _rel(tl, jl)
            assert tl.argmax() == jl.argmax()
            assert _rel(first, jl) <= FLIP_LOGIT_REL
            _assert_caches_match(tcache, jcache, FACTOR_LOGIT_REL)
            print(f"\n{jfn.__name__} on 'l': {flips} codes replayed, logits "
                  f"{_rel(first, jl):.2e} before, {_rel(tl, jl):.2e} after")

    def test_paged_step_matches_reference(self):
        # a prompt prefilled by the reference into a pool through a
        # permuted page table, then one paged fused step on "l" params:
        # o and down through the L-fused kernel (serve/paged.py takes
        # fused._qkv and fused._mlp_and_o)
        config, jparams, tparams = _params("tiny-mha-l")
        P, NP, pages = 8, 6, 3
        rng = np.random.default_rng(33)
        table = rng.permutation(NP - 1)[:pages].astype(np.int32)
        prompt = rng.integers(0, config.vocab_size, (1, 13)).astype(np.int32)
        pool = JP.paged_prefill_fused(
            jparams, jnp.asarray(prompt), JP.PagedQuantKVPool.create(
                config, NP, P), jnp.asarray(table), config, interpret=True)[1]
        arrays = [np.array(a) for a in pool]
        tpool = TP.PagedQuantKVPool(*[_torch_array(a).clone()
                                      for a in arrays])
        toks = np.asarray([17], np.int32)
        pos = np.asarray([13], np.int32)
        with _Rounding(JP.paged_decode_step_fused,
                       ("config", "interpret", "scratch_page", "tp_axis",
                        "attn_dots")) as rec:
            def run_jax():
                return rec.jax_step(
                    jparams, jnp.asarray(toks), jnp.asarray(pos),
                    JP.PagedQuantKVPool(*map(jnp.asarray, arrays)),
                    jnp.asarray(table[None]), config, interpret=True,
                    scratch_page=NP - 1, attn_dots="i8")

            def run_port():
                for f, a in zip(dataclasses.fields(tpool), arrays):
                    getattr(tpool, f.name).copy_(_torch_array(a))
                return TP.paged_decode_step_fused(
                    tparams, torch.from_numpy(toks.astype(np.int64)),
                    _t(pos), tpool, _t(table[None]), _port_config(config),
                    scratch_page=NP - 1, attn_dots="i8")[0].numpy()

            (jl, jpool), tl, _, flips, _ = _replay(
                rec, run_jax, run_port, FACTOR_MAX_FLIPS, FACTOR_RATIO_TOL)
        jl = np.asarray(jl)
        assert _rel(tl, jl) <= FACTOR_LOGIT_REL, _rel(tl, jl)
        assert (tl.argmax(-1) == jl.argmax(-1)).all()
        _assert_caches_match(tpool, jpool, FACTOR_LOGIT_REL)
