"""PyTorch port, the unfused compressed-model path: ``models/llama.py``'s
model functions, ``models/stacked.py``'s scan and W4A8 paths and the
interop loaders, against the JAX reference on the CPU.

Params: the reference's ``init_params`` weights, each projection packed by
the reference's ``compress_linear`` (grouped with bf16 factors and a bf16
head; or w4a8 with int8 factors and an int8 head), flattened to numpy and
loaded with the port's ``model_params_from_numpy``. The reference runs its
XLA twins (``use_pallas=False``), which its own engine uses on the CPU;
one case per kernel runs its Pallas kernels in interpret mode.

The w4a8 paths round activations (and int8 K/V) to int8, so their calls go
through the rounding replay of ``tests/test_torch_fused.py`` and are held to
the fused path's bound. The grouped path rounds only to bf16 (activations
before each dot, the bf16 cache): see ``GROUPED_REL``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.models import compressed as JC
from ee274_convexcaldera_llm_quantization_tpu.models import llama as JL
from ee274_convexcaldera_llm_quantization_tpu.models import stacked as JS
from ee274_convexcaldera_llm_quantization_tpu.models.config import (
    TINY, TINY_MHA)
from ee274_convexcaldera_llm_quantization_tpu_torch.interop import (
    model_params_from_numpy, stacked_params_from_numpy)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    stacked as TS)

from test_torch_fused import (  # noqa: F401 (a fixture)
    LOGIT_ATOL, LOGIT_RTOL, _Rounding, _assert_caches_match, _flatten,
    _one_torch_thread, _port_config, _reset, _replay)

# The grouped path rounds activations to bf16 before every dot and K/V to
# bf16 in the cache. The two programs compute the f32 values before a cast
# with sums in another order (a linear alone agrees to 5e-7 of outputs of
# 4), so a value within an f32 ulp of a bf16 rounding edge lands one bf16
# ulp (2^-8 relative) apart, and a flip carries through the later layers
# and the attention. One layer on the same input agrees to 2.4e-7; the
# whole 2-layer forward read 1.6e-3 (tiny) and 2.6e-3 (tiny-mha) relative
# (max abs 1.3e-2 of logits up to 4.3) against the reference run op by op
# or jitted alike. Bound: 4x the largest reading, relative Frobenius, and
# the reference test's atol on any one logit (tests/test_models.py).
GROUPED_REL, GROUPED_ATOL = 1e-2, 0.05
# prefill + decode against forward on the port alone: the bf16 cache rounds
# every K/V, and on the w4a8 path each rounding can flip int8 activation
# codes downstream (ROADMAP R6), so its logits drift further than the
# grouped path's (readings in PERF.md, CPU tests)
SELF_REL = {"grouped": 2e-2, "w4a8": 5e-2}

_NAMES = {"tiny": TINY, "tiny-mha": TINY_MHA}
_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
         "down_proj")


def _jax_model(config, mode, seed=0, tied=False):
    """The reference's compressed ModelParams: each projection's dense
    weight W split as Q = W - L @ R with seeded rank-8 factors and packed
    by ``compress_linear`` (4-bit, global scale 1.1); w4a8 models get int8
    factors and an int8 head."""
    rng = np.random.default_rng(seed)
    dense = JL.init_params(jax.random.PRNGKey(seed), config)

    def comp(lin):
        W = np.asarray(lin.w, np.float32)
        N, K = W.shape
        L = (rng.normal(size=(N, 8)) * 0.05).astype(np.float32)
        R = (rng.normal(size=(8, K)) * 0.05).astype(np.float32)
        out = JC.compress_linear(jnp.asarray((W - L @ R) / 1.1),
                                 jnp.asarray(L), jnp.asarray(R), 4,
                                 global_scale=1.1, mode=mode)
        return JC.quantize_factors_int8(out) if mode == "w4a8" else out

    def norm():
        return jnp.asarray(rng.uniform(0.5, 1.5, size=(config.hidden_size,))
                           .astype(np.float32))

    layers = [JL.LayerParams(attn_norm=norm(), mlp_norm=norm(),
                             **{n: comp(getattr(lp, n)) for n in _PROJ})
              for lp in dense.layers]
    head = None if tied else dense.lm_head
    if mode == "w4a8":
        head = JC.quantize_linear_int8(
            head or JC.DenseLinear(w=dense.embed))
    return JL.ModelParams(embed=dense.embed, layers=layers,
                          final_norm=norm(), lm_head=head)


def _to_numpy(params):
    """Reference params flattened for the interop loaders: (arrays, static
    fields)."""
    arrays, meta = {}, {}
    _flatten(params, "", arrays, meta)
    return arrays, meta


def _port_leaves(obj, prefix="", out=None):
    """Port params flattened in the same key layout: key -> tensor, and
    key -> value for every other (static) field."""
    out = {} if out is None else out
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif isinstance(obj, list):
        for i, o in enumerate(obj):
            _port_leaves(o, f"{prefix}.{i}", out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            key = f"{prefix}.{f.name}" if prefix else f.name
            _port_leaves(getattr(obj, f.name), key, out)
    elif obj is not None:
        out[prefix] = obj
    return out


_MODELS = {}


def _model(name, mode, tied=False):
    """(reference config, reference params, port params on the CPU)."""
    key = (name, mode, tied)
    if key not in _MODELS:
        config = _NAMES[name]
        jp = _jax_model(config, mode, tied=tied)
        _MODELS[key] = (config, jp, model_params_from_numpy(
            *_to_numpy(jp), device="cpu"))
    return _MODELS[key]


def _stacked(name, mode):
    config, jp, _ = _model(name, mode)
    js = JS.stack_layers(jp)
    return config, js, stacked_params_from_numpy(*_to_numpy(js),
                                                  device="cpu")


def _tokens(seed, config, shape):
    return np.random.default_rng(seed).integers(
        0, config.vocab_size, size=shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _compare(mode, fn, jfn, static, max_flips=None):
    """Run the reference (``jfn(jax_step)``) and the port (``fn()``, which
    must start from the same state each call) and hold the port to the
    bound of ``mode``; returns (reference output, port output, reading)."""
    if mode == "grouped":
        jout = jfn(None)
        tout = fn()
        return jout, tout, "no int8 rounding"
    with _Rounding(static[0], static=static[1]) as rec:
        jout, tout, first, flips, ratio = _replay(
            rec, lambda: jfn(rec.jax_step), fn, max_flips)
    return jout, tout, f"{flips} codes replayed (largest {ratio:.3f})"


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _close(mode, got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    rel = _rel(got, ref)
    if mode == "grouped":
        assert rel <= GROUPED_REL, rel
        np.testing.assert_allclose(got, ref, rtol=0, atol=GROUPED_ATOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    return rel


_LLAMA_STATIC = ("config", "use_pallas", "interpret")
MODES = ["grouped", "w4a8"]


class TestLlamaFunctions:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("name", ["tiny", "tiny-mha"])
    def test_forward_matches_reference(self, name, mode):
        config, jp, tp = _model(name, mode, tied=name == "tiny-mha")
        toks = _tokens(1, config, (2, 12))
        jout, tout, reading = _compare(
            mode, lambda: TL.forward(tp, _t(toks), _port_config(config))
            .numpy(),
            lambda step: (step or JL.forward)(jp, jnp.asarray(toks), config),
            (JL.forward, _LLAMA_STATIC))
        rel = _close(mode, tout, jout)
        print(f"\nforward {name} {mode}: {reading}; logits rel-Frobenius "
              f"{rel:.2e}")

    @pytest.mark.parametrize("mode", MODES)
    def test_forward_matches_pallas_kernels(self, mode):
        # the reference on its Pallas kernels (interpret mode): grouped runs
        # quantized_matmul, w4a8 quantized_matmul_w4a8 and int8_matmul
        config, jp, tp = _model("tiny", mode)
        toks = _tokens(2, config, (1, 8))
        jout, tout, _ = _compare(
            mode, lambda: TL.forward(tp, _t(toks), _port_config(config))
            .numpy(),
            lambda step: (step or JL.forward)(jp, jnp.asarray(toks), config,
                                              use_pallas=True,
                                              interpret=True),
            (JL.forward, _LLAMA_STATIC))
        _close(mode, tout, jout)

    @pytest.mark.parametrize("mode", MODES)
    def test_prefill_decode_matches_forward(self, mode):
        # the port against itself, as tests/test_models.py holds the
        # reference: prefill + decode_step reproduce the full forward
        # within the bf16 cache's rounding
        config, _, tp = _model("tiny", mode)
        cfg = _port_config(config)
        toks = _t(_tokens(3, config, (1, 10)))
        full = TL.forward(tp, toks, cfg).numpy()
        cache = TL.KVCache.create(cfg, 1, 16, device="cpu")
        logits, cache = TL.prefill(tp, toks[:, :6], cache, cfg)
        rels = [_rel(logits.numpy(), full[:, 5])]
        for pos in range(6, 10):
            logits, cache = TL.decode_step(tp, toks[:, pos], pos, cache, cfg)
            rels.append(_rel(logits.numpy(), full[:, pos]))
        print(f"\nprefill + decode_step vs forward {mode}: rel-Frobenius "
              f"{', '.join(f'{r:.2e}' for r in rels)}")
        assert max(rels) <= SELF_REL[mode], rels

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("name", ["tiny", "tiny-mha"])
    def test_decode_step_batched_ragged(self, name, mode):
        # rows at positions 3, 9 and 0 of a cache holding seeded bf16 K/V
        config, jp, tp = _model(name, mode)
        B, T = 3, 16
        rng = np.random.default_rng(4)
        shape = (config.num_layers, B, T, config.num_kv_heads,
                 config.head_dim)
        kv = [rng.normal(size=shape).astype(jnp.bfloat16) for _ in range(2)]
        toks = _tokens(5, config, (B,))
        pos = np.array([3, 9, 0], np.int32)
        tcache = TL.KVCache.create(_port_config(config), B, T, device="cpu")

        def port():
            _reset(tcache, kv)
            return TL.decode_step_batched(tp, _t(toks), torch.from_numpy(pos),
                                          tcache, _port_config(config)
                                          )[0].numpy()

        (jl, jcache), tl, reading = _compare(
            mode, port,
            lambda step: (step or JL.decode_step_batched)(
                jp, jnp.asarray(toks), jnp.asarray(pos),
                JL.KVCache(*map(jnp.asarray, kv)), config),
            (JL.decode_step_batched, _LLAMA_STATIC))
        rel = _close(mode, tl, jl)
        _assert_caches_match(tcache, jcache)
        print(f"\ndecode_step_batched {name} {mode}: {reading}; logits "
              f"rel-Frobenius {rel:.2e}")

    @pytest.mark.parametrize("mode", MODES)
    def test_prefill_into_slot_bucket(self, mode):
        # a 5-token prompt right-padded to its 8-token bucket, into slot 1;
        # logits at last_pos 4; the pad tokens' K/V land in the cache too
        config, jp, tp = _model("tiny", mode)
        B, T = 2, 16
        prompt = np.zeros((1, 8), np.int32)
        prompt[0, :5] = _tokens(6, config, (5,))
        tcache = TL.KVCache.create(_port_config(config), B, T, device="cpu")
        zeros = [np.zeros(tcache.k.shape, jnp.bfloat16)] * 2

        def port():
            _reset(tcache, zeros)
            return TL.prefill_into_slot(tp, _t(prompt), 1, tcache,
                                        _port_config(config),
                                        last_pos=4)[0].numpy()

        (jl, jcache), tl, reading = _compare(
            mode, port,
            lambda step: (step or JL.prefill_into_slot)(
                jp, jnp.asarray(prompt), jnp.asarray(1),
                JL.KVCache.create(config, B, T), config,
                last_pos=jnp.asarray(4)),
            (JL.prefill_into_slot, _LLAMA_STATIC))
        _close(mode, tl, jl)
        _assert_caches_match(tcache, jcache)
        print(f"\nprefill_into_slot {mode}: {reading}")

    @pytest.mark.parametrize("mode", MODES)
    def test_generate_greedy_tokens_equal(self, mode):
        # the reference's generate_greedy calls its jitted prefill and
        # decode_step, which retrace inside the recorder (its own jit of
        # forward is unused here)
        config, jp, tp = _model("tiny", mode)
        prompt = _tokens(7, config, (2, 5))
        jout, tout, reading = _compare(
            mode, lambda: TL.generate_greedy(tp, _t(prompt), 6,
                                             _port_config(config)).numpy(),
            lambda step: JL.generate_greedy(jp, jnp.asarray(prompt), 6,
                                            config),
            (JL.forward, _LLAMA_STATIC), max_flips=64)
        assert tout.shape == (2, 11)
        np.testing.assert_array_equal(tout, np.asarray(jout))
        print(f"\ngenerate_greedy {mode}: {reading}")

    def test_init_params_shapes_match_reference(self):
        jp = JL.init_params(jax.random.PRNGKey(0), TINY)
        tp = TL.init_params(0, _port_config(TINY), device="cpu")
        ja, _ = _to_numpy(jp)
        ta = _port_leaves(tp)
        assert sorted(ja) == sorted(ta)
        for k, a in ja.items():
            assert tuple(ta[k].shape) == a.shape, k
            assert str(ta[k].dtype).split(".")[-1] == a.dtype.name, k


class TestStacked:
    @pytest.mark.parametrize("mode", MODES)
    def test_stack_layers_and_interop_agree(self, mode):
        # the port's stack_layers of the per-layer params equals the
        # reference's stacked params carried over by the interop loader
        config, _, tp = _model("tiny", mode)
        _, _, ts = _stacked("tiny", mode)
        mine = TS.stack_layers(tp)
        ma, sa = _port_leaves(mine), _port_leaves(ts)
        assert sorted(ma) == sorted(sa)
        for k, a in ma.items():
            if isinstance(a, torch.Tensor):
                assert a.dtype == sa[k].dtype and torch.equal(a, sa[k]), k
            else:
                assert a == sa[k], k
        assert TS.layer_view(mine.layers, 1).q_proj.packed.data_ptr() == (
            mine.layers.q_proj.packed[1].data_ptr())

    @pytest.mark.parametrize("mode", MODES)
    def test_scan_path_equals_unrolled(self, mode):
        # the stacked forward / prefill / decode_step_batched run the
        # unrolled block over layer views: equal bit for bit
        config, _, tp = _model("tiny", mode)
        cfg = _port_config(config)
        _, _, ts = _stacked("tiny", mode)
        toks = _t(_tokens(8, config, (2, 6)))
        assert torch.equal(TS.forward(ts, toks, cfg), TL.forward(tp, toks,
                                                                 cfg))
        caches = [TL.KVCache.create(cfg, 2, 16, device="cpu")
                  for _ in range(2)]
        lu, _ = TL.prefill(tp, toks, caches[0], cfg)
        ls, _ = TS.prefill(ts, toks, caches[1], cfg)
        assert torch.equal(lu, ls)
        pos = torch.tensor([6, 3], dtype=torch.int32)
        lu, cu = TL.decode_step_batched(tp, toks[:, 0], pos, caches[0], cfg)
        ls, cs = TS.decode_step_batched(ts, toks[:, 0], pos, caches[1], cfg)
        assert torch.equal(lu, ls)
        assert torch.equal(cu.k, cs.k) and torch.equal(cu.v, cs.v)

    def test_quantize_model_factors_int8_matches_reference(self):
        # grouped stacked params with bf16 factors and head -> int8
        config, js, ts = _stacked("tiny", "grouped")
        mine = TS.quantize_model_factors_int8(ts)
        ref = stacked_params_from_numpy(
            *_to_numpy(JS.quantize_model_factors_int8(js)), device="cpu")
        ma, ra = _port_leaves(mine), _port_leaves(ref)
        assert sorted(ma) == sorted(ra)
        for k, a in ma.items():
            if not isinstance(a, torch.Tensor):
                assert a == ra[k], k
                continue
            assert a.dtype == ra[k].dtype, k
            # scales: XLA may divide by 127 as a multiplication by its
            # reciprocal, one f32 ulp; codes equal
            torch.testing.assert_close(a.float(), ra[k].float(),
                                       rtol=2.0 ** -23, atol=0, msg=k)

    @pytest.mark.parametrize("cache", ["bf16", "quant"])
    def test_decode_step_w4a8_matches_reference(self, cache):
        # three steps at ragged positions, each from the reference's cache;
        # the reference runs the stacked W4A8 Pallas kernel (interpret)
        config, js, ts = _stacked("tiny", "w4a8")
        cfg = _port_config(config)
        B, T = 3, 16
        jcls, tcls = {"bf16": (JL.KVCache, TL.KVCache),
                      "quant": (JL.QuantKVCache, TL.QuantKVCache)}[cache]
        jcache = jcls.create(config, B, T)
        tcache = tcls.create(cfg, B, T, device="cpu")
        toks = _tokens(9, config, (B,))
        readings = []
        with _Rounding(JS.decode_step_w4a8,
                       static=("config", "interpret", "tp_axis")) as rec:
            for step in range(3):
                pos = np.array([step, 4 + step, 9 + step], np.int32)
                pre = [np.array(a) for a in jcache]

                def port():
                    _reset(tcache, pre)
                    return TS.decode_step_w4a8(
                        ts, _t(toks), torch.from_numpy(pos), tcache,
                        cfg)[0].numpy()

                (jl, jcache), tl, _, flips, _ = _replay(
                    rec, lambda: rec.jax_step(js, jnp.asarray(toks),
                                              jnp.asarray(pos), jcache,
                                              config, interpret=True), port)
                _close("w4a8", tl, jl)
                _assert_caches_match(tcache, jcache)
                readings.append(flips)
                toks = np.asarray(jl).argmax(-1).astype(np.int32)
        print(f"\ndecode_step_w4a8 {cache}: codes replayed per step "
              f"{readings}")

    @pytest.mark.parametrize("cache", ["bf16", "quant"])
    def test_prefill_into_slot_w4a8_matches_reference(self, cache):
        config, js, ts = _stacked("tiny", "w4a8")
        cfg = _port_config(config)
        B, T = 2, 16
        jcls, tcls = {"bf16": (JL.KVCache, TL.KVCache),
                      "quant": (JL.QuantKVCache, TL.QuantKVCache)}[cache]
        prompt = np.zeros((1, 8), np.int32)
        prompt[0, :6] = _tokens(10, config, (6,))
        jcache = jcls.create(config, B, T)
        tcache = tcls.create(cfg, B, T, device="cpu")
        pre = [np.array(a) for a in jcache]

        def port():
            _reset(tcache, pre)
            return TS.prefill_into_slot_w4a8(ts, _t(prompt), 1, tcache, cfg,
                                             last_pos=5)[0].numpy()

        with _Rounding(JS.prefill_into_slot_w4a8,
                       static=("config", "interpret", "tp_axis")) as rec:
            (jl, jcache), tl, _, flips, _ = _replay(
                rec, lambda: rec.jax_step(js, jnp.asarray(prompt),
                                          jnp.asarray(1), jcache, config,
                                          interpret=True,
                                          last_pos=jnp.asarray(5)),
                port, 64)
        _close("w4a8", tl, jl)
        _assert_caches_match(tcache, jcache, 5e-4)
        print(f"\nprefill_into_slot_w4a8 {cache}: {flips} codes replayed")

    def test_w4a8_path_input_rules(self):
        _, _, ts = _stacked("tiny", "grouped")
        cfg = _port_config(TINY)
        cache = TL.KVCache.create(cfg, 1, 8, device="cpu")
        tok, pos = torch.tensor([1]), torch.tensor([0], dtype=torch.int32)
        with pytest.raises(ValueError, match="w4a8"):
            TS.decode_step_w4a8(ts, tok, pos, cache, cfg)
        _, _, tw = _stacked("tiny", "w4a8")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TS.decode_step_w4a8(tw, tok, pos, cache, cfg, tp_axis="tp")
        with pytest.raises(TypeError, match="KVCache"):
            TS.decode_step_w4a8(tw, tok, pos, TL.HeadMajorQuantKVCache.create(
                cfg, 1, 8, device="cpu"), cfg)
        with pytest.raises(ValueError, match="heterogeneous"):
            config, _, tp = _model("tiny", "w4a8")
            mixed = dataclasses.replace(tp, layers=[
                tp.layers[0], dataclasses.replace(
                    tp.layers[1], q_proj=_model("tiny", "grouped")[2]
                    .layers[1].q_proj)])
            TS.stack_layers(mixed)
