"""PyTorch port, ``models/mixed.py`` (mixed-width serving), against the JAX
reference's ``models.mixed`` (Pallas kernels in interpret mode).

The reference's own test model (``tests/test_mixed.py``): four TINY layers
at Q bits [2, 4, 8, 4], layer 1's down_proj left dense, compressed by the
reference's ``compress_linear``; flattened to numpy, loaded with the port's
``interop.model_params_from_numpy`` and stacked with the port's own
``stack_layers_mixed``. Each step starts both programs from the reference's
cache, and a code the two programs round to different sides of an edge is
replayed with the reference's rounding before the step is held to the
tight bound (``tests/test_torch_fused.py::_replay``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.models import llama as JL
from ee274_convexcaldera_llm_quantization_tpu.models import mixed as JM
from ee274_convexcaldera_llm_quantization_tpu.models.compressed import (
    CalderaLinear as JCalderaLinear, DenseLinear as JDenseLinear,
    compress_linear as j_compress_linear,
    quantize_factors_int8 as j_quantize_factors_int8)
from ee274_convexcaldera_llm_quantization_tpu.models.config import (
    TINY, TINY_MHA)
from ee274_convexcaldera_llm_quantization_tpu_torch.interop import (
    model_params_from_numpy)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.models import mixed as TM
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear, quantize_factors_int8)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.surgery import (
    compress_model_with_budget)
from ee274_convexcaldera_llm_quantization_tpu_torch.decomp.caldera import (
    CalderaParams)

from test_torch_fused import (  # noqa: F401 (a fixture)
    LOGIT_ATOL, LOGIT_RTOL, _assert_caches_match, _CACHES, _flatten,
    _one_torch_thread, _port_config, _replay, _reset, _Rounding)

CFG4 = dataclasses.replace(TINY, num_layers=4)
BITS_SCHEDULE = [2, 4, 8, 4]
# the reference's staged-against-inline bound (tests/test_mixed.py): the
# staged kernel adds the current token apart, an f32 sum in another order
STAGED_RTOL = STAGED_ATOL = 2e-4


def _convert(lp, bits, rng, rank, dense=()):
    """The reference's layer with every projection not in ``dense``
    compressed at ``bits`` with rank-``rank`` factors."""
    fields = {}
    for name in JL.LayerParams._fields:
        lin = getattr(lp, name)
        if not isinstance(lin, JDenseLinear) or name in dense:
            fields[name] = lin
            continue
        m, k = lin.w.shape
        L = jnp.asarray(rng.normal(size=(m, rank)).astype(np.float32) * 0.05)
        R = jnp.asarray(rng.normal(size=(rank, k)).astype(np.float32) * 0.05)
        fields[name] = j_compress_linear(lin.w.astype(jnp.float32), L, R,
                                         bits, global_scale=1.0, bias=lin.b,
                                         mode="w4a8")
    return JL.LayerParams(**fields)


def _to_port_model(jmodel):
    arrays, meta = {}, {}
    _flatten(jmodel, "", arrays, meta)
    return model_params_from_numpy(arrays, meta, device="cpu")


@pytest.fixture(scope="module")
def mixed_model():
    """(reference per-layer model, reference stacked, port stacked): the
    reference's 4-layer [2, 4, 8, 4]-bit model, layer 1's down_proj
    dense."""
    params = JL.init_params(jax.random.PRNGKey(0), CFG4)
    rng = np.random.default_rng(7)
    jmodel = JL.ModelParams(
        embed=params.embed,
        layers=[_convert(lp, BITS_SCHEDULE[i], rng, 4,
                         ("down_proj",) if i == 1 else ())
                for i, lp in enumerate(params.layers)],
        final_norm=params.final_norm, lm_head=params.lm_head)
    return (jmodel, JM.stack_layers_mixed(jmodel),
            TM.stack_layers_mixed(_to_port_model(jmodel)))


_PREFILLED = {}


def _prefilled(jmp, cache_kind, T=16):
    """The reference's cache with a 5-token prompt prefilled into slot 0
    on the mixed path (one per cache kind, made once), and a port cache of
    the same kind."""
    jcls, tcls = _CACHES[cache_kind]
    if cache_kind not in _PREFILLED:
        prompt = np.random.default_rng(3).integers(
            1, CFG4.vocab_size, size=(1, 5)).astype(np.int32)
        _PREFILLED[cache_kind] = JM.prefill_into_slot_mixed(
            jmp, jnp.asarray(prompt), jnp.int32(0), jcls.create(CFG4, 2, T),
            CFG4, interpret=True)[1]
    return (_PREFILLED[cache_kind],
            tcls.create(_port_config(CFG4), 2, T, device="cpu"))


def _step_vs_reference(rec, jparams, toks, pos, jkw, tfn, jcache, tcache):
    """One decode step of the reference (``rec.jax_step`` on ``jparams``
    with ``jkw``) and of the port (``tfn(tokens, pos, cache)``) from the
    same cache, roundings replayed; logits held to the fused step's bound,
    K/V codes equal. Returns the codes replayed."""
    pre = [np.array(a) for a in jcache]

    def run_jax():
        return rec.jax_step(jparams, jnp.asarray(toks), jnp.asarray(pos),
                            jcache, CFG4, interpret=True, **jkw)

    def run_port():
        _reset(tcache, pre)
        return tfn(torch.from_numpy(toks.astype(np.int64)),
                   torch.from_numpy(pos), tcache)[0].numpy()

    (jl, jout), tl, _, flips, _ = _replay(rec, run_jax, run_port)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(tl.argmax(-1), np.asarray(jl).argmax(-1))
    _assert_caches_match(tcache, jout)
    return flips


class TestBucketing:
    @pytest.mark.parametrize("name", TM._PROJ_NAMES)
    def test_maps_match_reference(self, mixed_model, name):
        _, jmp, tmp = mixed_model
        jp, tp = getattr(jmp.layers, name), getattr(tmp.layers, name)
        assert tp.bucket_of_static == jp.bucket_of_static
        assert tp.index_in_static == jp.index_in_static
        np.testing.assert_array_equal(tp.bucket_of.numpy(),
                                      np.asarray(jp.bucket_of))
        np.testing.assert_array_equal(tp.index_in.numpy(),
                                      np.asarray(jp.index_in))
        assert TM.num_bits_per_layer(tp) == JM.num_bits_per_layer(jp)
        for jb, tb in zip(jp.buckets, tp.buckets, strict=True):
            assert type(tb).__name__ == type(jb).__name__
            if isinstance(tb, CalderaLinear):
                assert (tb.num_bits, tb.grid_bits) == (jb.num_bits,
                                                       jb.grid_bits)
                np.testing.assert_array_equal(tb.packed.numpy(),
                                              np.asarray(jb.packed))
            else:
                assert tuple(tb.w.shape) == jb.w.shape

    def test_reference_layout(self, mixed_model):
        # bits [2, 4, 8, 4]: 3 buckets, layers 1 and 3 share bucket 1; the
        # dense down_proj of layer 1 rides a DenseLinear bucket (16 bits)
        tmp = mixed_model[2]
        q = tmp.layers.q_proj
        assert q.bucket_of_static == (0, 1, 2, 1)
        assert q.index_in_static == (0, 0, 0, 1)
        assert [b.num_bits for b in q.buckets] == [2, 4, 8]
        assert q.buckets[1].packed.shape[0] == 2
        assert TM.num_bits_per_layer(q) == BITS_SCHEDULE
        down = TM.num_bits_per_layer(tmp.layers.down_proj)
        assert down == [2, 16, 8, 4]
        assert any(isinstance(b, DenseLinear)
                   for b in tmp.layers.down_proj.buckets)

    def test_grouped_mode_rejected(self, mixed_model):
        model = _to_port_model(mixed_model[0])
        model.layers[0].q_proj = dataclasses.replace(
            model.layers[0].q_proj, mode="grouped")
        with pytest.raises(ValueError, match="w4a8"):
            TM.stack_layers_mixed(model)


class TestAgainstReference:
    @pytest.mark.parametrize("cache_kind", ["bf16", "quant", "head"])
    def test_prefill_then_switch_decode(self, mixed_model, cache_kind):
        # prefill_into_slot_mixed of a 6-token prompt into slot 1, then
        # decode_step_mixed at ragged positions from the reference's cache
        _, jmp, tmp = mixed_model
        cfg = _port_config(CFG4)
        jcls, tcls = _CACHES[cache_kind]
        jcache = jcls.create(CFG4, 2, 16)
        tcache = tcls.create(cfg, 2, 16, device="cpu")
        prompt = np.random.default_rng(9).integers(
            1, CFG4.vocab_size, size=(1, 6)).astype(np.int32)
        with _Rounding(fn=JM.prefill_into_slot_mixed,
                       static=("config", "interpret")) as rec:
            pre = [np.array(a) for a in jcache]

            def run_jax():
                return rec.jax_step(jmp, jnp.asarray(prompt), jnp.int32(1),
                                    jcache, CFG4, interpret=True)

            def run_port():
                _reset(tcache, pre)
                return TM.prefill_into_slot_mixed(
                    tmp, torch.from_numpy(prompt.astype(np.int64)), 1,
                    tcache, cfg)[0].numpy()

            (jl, jcache), tl, _, _, _ = _replay(rec, run_jax, run_port)
            np.testing.assert_allclose(tl, np.asarray(jl), rtol=LOGIT_RTOL,
                                       atol=LOGIT_ATOL)
            _assert_caches_match(tcache, jcache)
        with _Rounding(fn=JM.decode_step_mixed,
                       static=("config", "interpret")) as rec:
            _step_vs_reference(
                rec, jmp, np.array([11, 12], np.int32),
                np.array([3, 6], np.int32), {},
                lambda t, p, c: TM.decode_step_mixed(tmp, t, p, c, cfg),
                jcache, tcache)

    @pytest.mark.parametrize("staged,dots", [(True, "i8"), (False, "f32")])
    def test_segmented_decode(self, mixed_model, staged, dots):
        _, jmp, tmp = mixed_model
        cfg = _port_config(CFG4)
        jcache, tcache = _prefilled(jmp, "head")
        with _Rounding(fn=JM.decode_step_mixed_segmented,
                       static=("config", "interpret", "staged_kv",
                               "attn_dots")) as rec:
            _step_vs_reference(
                rec, jmp, np.array([3, 4], np.int32),
                np.array([5, 2], np.int32),
                dict(staged_kv=staged, attn_dots=dots),
                lambda t, p, c: TM.decode_step_mixed_segmented(
                    tmp, t, p, c, cfg, staged_kv=staged, attn_dots=dots),
                jcache, tcache)

    def test_fused_segments(self):
        # TINY_MHA at widths [4, 2], rank-128 int8 factors: two segments,
        # each fusing qkv and gate/up on factor path "l" (the reference's
        # test_fused_segments_match, here with two widths)
        params = JL.init_params(jax.random.PRNGKey(3), TINY_MHA)
        rng = np.random.default_rng(5)
        jmodel = JL.ModelParams(
            embed=params.embed,
            layers=[_convert(lp, bits, rng, 128)
                    for lp, bits in zip(params.layers, (4, 2))],
            final_norm=params.final_norm, lm_head=params.lm_head)
        jmp = JM.stack_layers_mixed(jmodel)
        tmp = TM.stack_layers_mixed(_to_port_model(jmodel))

        def q8(mp, quant):
            return dataclasses.replace(mp, buckets=tuple(
                quant(b) if isinstance(b, (JCalderaLinear, CalderaLinear))
                else b for b in mp.buckets))
        jmp = jmp._replace(layers=jmp.layers._replace(**{
            n: q8(getattr(jmp.layers, n), j_quantize_factors_int8)
            for n in TM._PROJ_NAMES}))
        tmp = dataclasses.replace(tmp, layers=dataclasses.replace(
            tmp.layers, **{n: q8(getattr(tmp.layers, n),
                                 quantize_factors_int8)
                           for n in TM._PROJ_NAMES}))
        cfg = _port_config(TINY_MHA)
        jprep = JM.prepare_fused_segments(jmp, TINY_MHA)
        tprep = TM.prepare_fused_segments(tmp, cfg)
        assert len(tprep) == 2
        assert [{k: v is None for k, v in p.items()} for p in tprep] == \
            [{k: v is None for k, v in p.items()} for p in jprep]
        assert all(p["qkv"] is not None and p["gateup"] is not None
                   for p in tprep)
        for p in tprep:
            for fp in p.values():
                assert fp.factor_kernel == "l"
                assert all(t.is_contiguous() for t in (
                    fp.packed, fp.scales, fp.R, fp.L_cat, fp.L_scale_cat))
        toks = np.array([1, 2], np.int32)
        pos = np.array([2, 3], np.int32)
        jcache = JL.HeadMajorQuantKVCache.create(TINY_MHA, 2, 16)
        tcache = TL.HeadMajorQuantKVCache.create(cfg, 2, 16, device="cpu")
        # against the reference's own jit: no code rounds the other way
        # here. (The rounding recorder's instrumented jit of the reference
        # drifts on this model by 6.5e-2 in the logits from the reference's
        # own: with rank-128 factors of this size, the bf16 casts before the
        # factor dots that XLA keeps or drops move K by ~1e-3 relative.)
        jl, jout = JM.decode_step_mixed_segmented(
            jmp, jnp.asarray(toks), jnp.asarray(pos), jcache, TINY_MHA,
            interpret=True, fused_prep=jprep)
        tl = TM.decode_step_mixed_segmented(
            tmp, torch.from_numpy(toks.astype(np.int64)),
            torch.from_numpy(pos), tcache, cfg, fused_prep=tprep)[0].numpy()
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)
        _assert_caches_match(tcache, jout)
        # fused against unfused segments in the port: the int8 factor codes
        # concatenate exactly, only the f32 sums' order differs (the
        # reference's bound)
        unfused = TM.decode_step_mixed_segmented(
            tmp, torch.from_numpy(toks.astype(np.int64)),
            torch.from_numpy(pos),
            TL.HeadMajorQuantKVCache.create(cfg, 2, 16, device="cpu"),
            cfg)[0].numpy()
        np.testing.assert_allclose(tl, unfused, rtol=STAGED_RTOL,
                                   atol=STAGED_ATOL)


class TestPortRelations:
    def _step(self, tmp, fn, cache=None, **kw):
        cfg = _port_config(CFG4)
        cache = cache or TL.HeadMajorQuantKVCache.create(cfg, 2, 16,
                                                         device="cpu")
        logits, cache = fn(tmp, torch.tensor([1, 2]),
                           torch.tensor([2, 3], dtype=torch.int32), cache,
                           cfg, **kw)
        return logits, cache

    def test_segmented_equals_switch(self, mixed_model):
        # every layer its own signature here (4 runs, the worst case); the
        # inline segmented step takes the same kernels in the same order as
        # the switch path: bit for bit
        tmp = mixed_model[2]
        assert len(TM.mixed_segments(tmp.layers, 4)) == 4
        la, ca = self._step(tmp, TM.decode_step_mixed)
        lb, cb = self._step(tmp, TM.decode_step_mixed_segmented,
                            staged_kv=False)
        assert torch.equal(la, lb)
        for f in dataclasses.fields(ca):
            assert torch.equal(getattr(ca, f.name), getattr(cb, f.name))
        # staged: the same committed codes, logits to the staged kernel's
        # f32 reordering
        lc, cc = self._step(tmp, TM.decode_step_mixed_segmented)
        np.testing.assert_allclose(lc.numpy(), la.numpy(), rtol=STAGED_RTOL,
                                   atol=STAGED_ATOL)
        assert torch.equal(la.argmax(-1), lc.argmax(-1))
        assert torch.equal(ca.k, cc.k) and torch.equal(ca.v, cc.v)

    def test_truncate_keeps_widths_and_views(self, mixed_model):
        tmp = mixed_model[2]
        draft = TM.truncate_mixed(tmp, 2)
        for n in TM._PROJ_NAMES:
            full, cut = getattr(tmp.layers, n), getattr(draft.layers, n)
            assert TM.num_bits_per_layer(cut) == \
                TM.num_bits_per_layer(full)[:2]
            assert cut.index_in_static == full.index_in_static[:2]
            for b in cut.buckets:    # leading-axis views of the target's
                t = b.packed if isinstance(b, CalderaLinear) else b.w
                assert t._base is not None
        assert draft.layers.attn_norm.shape[0] == 2
        # the truncated model is the target's first two layers: one step
        # equals the step of the same two layers bucketed afresh
        model = _to_port_model(mixed_model[0])
        model.layers = model.layers[:2]
        cfg2 = dataclasses.replace(_port_config(CFG4), num_layers=2)
        cache = TL.KVCache.create(cfg2, 2, 16, device="cpu")
        a, _ = TM.decode_step_mixed(draft, torch.tensor([1, 2]),
                                    torch.tensor([0, 1], dtype=torch.int32),
                                    cache, cfg2)
        b, _ = TM.decode_step_mixed(
            TM.stack_layers_mixed(model), torch.tensor([1, 2]),
            torch.tensor([0, 1], dtype=torch.int32),
            TL.KVCache.create(cfg2, 2, 16, device="cpu"), cfg2)
        assert torch.equal(a, b)

    def test_truncate_asserts_leading_prefix(self, mixed_model):
        # R3: a bucket whose kept members are not its first ones (maps that
        # stack_layers_mixed never builds) cannot be cut as a leading slice
        tmp = mixed_model[2]
        q = tmp.layers.q_proj                # bucket 1 holds layers 1 and 3
        swapped = dataclasses.replace(q, index_in_static=(0, 1, 0, 0))
        bad = dataclasses.replace(tmp, layers=dataclasses.replace(
            tmp.layers, q_proj=swapped))
        TM.truncate_mixed(bad, 1)            # bucket 0 only: still a prefix
        with pytest.raises(ValueError, match="leading prefix"):
            TM.truncate_mixed(bad, 2)

    def test_segmented_requires_head_major(self, mixed_model):
        cfg = _port_config(CFG4)
        with pytest.raises(ValueError, match="HeadMajorQuantKVCache"):
            self._step(mixed_model[2], TM.decode_step_mixed_segmented,
                       cache=TL.QuantKVCache.create(cfg, 2, 16,
                                                    device="cpu"))

    def test_budget_allocation_serves(self):
        # compress_model_with_budget -> stack_layers_mixed -> decode and
        # prefill (the reference's TestBudgetToServing, on the port)
        cfg = _port_config(TINY)
        params = TL.init_params(1, cfg, device="cpu")
        cp = CalderaParams(Q_bits=4, L_bits=16, R_bits=16, rank=4, iters=1,
                           lplr_iters=1)
        qparams, _, alloc = compress_model_with_budget(
            params, cp, B_tot=4.0, menu=(2, 4, 8), serving_mode="w4a8")
        assert alloc.avg_bits <= 4.0 + 1e-9
        mp = TM.stack_layers_mixed(qparams)
        cache = TL.HeadMajorQuantKVCache.create(cfg, 2, 16, device="cpu")
        lg, cache = TM.prefill_into_slot_mixed(mp, torch.tensor([[3, 4, 5]]),
                                               0, cache, cfg)
        logits, _ = TM.decode_step_mixed_segmented(
            mp, torch.tensor([1, 2]), torch.tensor([3, 0], dtype=torch.int32),
            cache, cfg, attn_dots="i8")
        assert torch.isfinite(lg).all() and torch.isfinite(logits).all()
        assert logits.shape == (2, cfg.vocab_size)
