"""PyTorch port, ``serve/speculative.py`` and ``serve/spec_engine.py``
(speculative decoding), against the JAX reference's ``serve.speculative``
(Pallas kernels in interpret mode) and against the port's own plain decode.

Targets: the fused TINY params of ``tests/test_torch_fused.py`` (the
reference's ``bench.build_compressed_llama_params``, int8 factors and head,
loaded with ``interop.fused_params_from_numpy``), and the reference's
4-layer [4, 2, 2, 4]-bit mixed model of ``tests/test_speculative.py``
(compressed by the reference, loaded with ``model_params_from_numpy`` and
stacked by the port's ``stack_layers_mixed``). Whole runs are compared
through the rounding replay of ``tests/test_torch_fused.py::_replay``: a
code the two programs round to different sides of an edge is replayed with
the reference's rounding, then the outputs must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.models import fused as JF
from ee274_convexcaldera_llm_quantization_tpu.models import llama as JL
from ee274_convexcaldera_llm_quantization_tpu.models import mixed as JM
from ee274_convexcaldera_llm_quantization_tpu.models.config import TINY
from ee274_convexcaldera_llm_quantization_tpu.serve import speculative as JSP
from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused as TF
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.models import mixed as TM
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import engine as TE
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
    fast_engine as TFE)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
    spec_engine as TSE)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
    speculative as TSP)

from test_torch_fused import (  # noqa: F401 (a fixture)
    LOGIT_ATOL, LOGIT_RTOL, _CACHES, _assert_caches_match,
    _one_torch_thread, _params, _port_config, _replay, _reset, _Rounding)
from test_torch_mixed import _convert, _to_port_model

# the reference's verify-against-sequential bounds (tests/
# test_speculative.py): the S-token window and S one-token steps sum the
# same products in other orders, and an int8 code can round the other way
SEQ_LOGIT_ATOL, SEQ_CACHE_ATOL = 2e-3, 2e-2
# a whole generation (prefills, rounds) may replay more codes than one
# step; the engine tests allow as many (tests/test_torch_serve.py)
RUN_MAX_FLIPS = 64
CFG4 = dataclasses.replace(TINY, num_layers=4)


def _target():
    config, jp, tp = _params("tiny")
    return config, _port_config(config), jp, tp


def _prompts(B, S, seed, vocab):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def mixed_model():
    """(reference stacked, port stacked): the reference's two-segment
    [4, 2, 2, 4]-bit model, like the 13B flagship's."""
    base = JL.init_params(jax.random.PRNGKey(2), CFG4)
    rng = np.random.default_rng(17)
    jmodel = JL.ModelParams(
        embed=base.embed,
        layers=[_convert(lp, bits, rng, 4)
                for lp, bits in zip(base.layers, (4, 2, 2, 4))],
        final_norm=base.final_norm, lm_head=base.lm_head)
    return (JM.stack_layers_mixed(jmodel),
            TM.stack_layers_mixed(_to_port_model(jmodel)))


def _port_prefill(params, cfg, cache, prompts, mixed=False):
    fn = TM.prefill_into_slot_mixed if mixed else TF.prefill_into_slot_fused
    for b in range(prompts.shape[0]):
        _, cache = fn(params, _t(prompts[b:b + 1]), b, cache, cfg)
    return cache


class TestVerifyStep:
    @pytest.mark.parametrize("cache_kind", ["bf16", "quant", "head"])
    def test_matches_reference(self, cache_kind):
        # a 3-token window at ragged positions over two prefilled rows, from
        # the reference's cache
        config, cfg, jp, tp = _target()
        jcls, tcls = _CACHES[cache_kind]
        jcache = jcls.create(config, 2, 32)
        for b, prompt in enumerate(_prompts(2, 6, 3, config.vocab_size)):
            _, jcache = JF.prefill_into_slot_fused(
                jp, jnp.asarray(prompt[None]), jnp.asarray(b), jcache,
                config, interpret=True)
        tcache = tcls.create(cfg, 2, 32, device="cpu")
        window = _prompts(2, 3, 9, config.vocab_size)
        pos = np.array([6, 4], np.int32)
        pre = [np.array(a) for a in jcache]
        with _Rounding(fn=JSP.verify_step_fused,
                       static=("config", "interpret")) as rec:
            def run_jax():
                return rec.jax_step(jp, jnp.asarray(window),
                                    jnp.asarray(pos), jcache, config,
                                    interpret=True)

            def run_port():
                _reset(tcache, pre)
                return TSP.verify_step_fused(tp, _t(window),
                                             torch.from_numpy(pos), tcache,
                                             cfg)[0].numpy()

            (jl, jout), tl, _, _, _ = _replay(rec, run_jax, run_port)
        assert tl.shape == (2, 3, config.vocab_size)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)
        _assert_caches_match(tcache, jout)

    @pytest.mark.parametrize("cache_kind", ["bf16", "quant", "head"])
    def test_matches_sequential_decode(self, cache_kind):
        # an S-token verify step gives the logits and cache of S one-token
        # decode steps (the reference's relation and bounds)
        config, cfg, _, tp = _target()
        tcls = _CACHES[cache_kind][1]
        prompts = _prompts(2, 6, 3, config.vocab_size)
        window = _prompts(2, 3, 9, config.vocab_size)
        pos = torch.full((2,), 6, dtype=torch.int32)
        ca = _port_prefill(tp, cfg, tcls.create(cfg, 2, 32, device="cpu"),
                           prompts)
        cb = _port_prefill(tp, cfg, tcls.create(cfg, 2, 32, device="cpu"),
                           prompts)
        seq = []
        for i in range(3):
            lg, ca = TF.decode_step_fused(tp, _t(window[:, i]), pos + i, ca,
                                          cfg)
            seq.append(lg)
        ver, cb = TSP.verify_step_fused(tp, _t(window), pos, cb, cfg)
        np.testing.assert_allclose(ver.numpy(), torch.stack(seq, 1).numpy(),
                                   rtol=0, atol=SEQ_LOGIT_ATOL)
        for f in dataclasses.fields(ca):
            np.testing.assert_allclose(
                getattr(ca, f.name).float().numpy(),
                getattr(cb, f.name).float().numpy(), rtol=0,
                atol=SEQ_CACHE_ATOL)

    def test_mixed_matches_reference(self, mixed_model):
        jmp, tmp = mixed_model
        cfg = _port_config(CFG4)
        jcache = JL.HeadMajorQuantKVCache.create(CFG4, 2, 32)
        for b, prompt in enumerate(_prompts(2, 5, 13, CFG4.vocab_size)):
            _, jcache = JM.prefill_into_slot_mixed(
                jmp, jnp.asarray(prompt[None]), jnp.int32(b), jcache, CFG4,
                interpret=True)
        tcache = TL.HeadMajorQuantKVCache.create(cfg, 2, 32, device="cpu")
        window = _prompts(2, 4, 21, CFG4.vocab_size)
        pos = np.array([5, 3], np.int32)
        pre = [np.array(a) for a in jcache]
        with _Rounding(fn=JSP.verify_step_mixed,
                       static=("config", "interpret")) as rec:
            def run_jax():
                return rec.jax_step(jmp, jnp.asarray(window),
                                    jnp.asarray(pos), jcache, CFG4,
                                    interpret=True)

            def run_port():
                _reset(tcache, pre)
                return TSP.verify_step_mixed(tmp, _t(window),
                                             torch.from_numpy(pos), tcache,
                                             cfg)[0].numpy()

            (jl, jout), tl, _, _, _ = _replay(rec, run_jax, run_port)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)
        _assert_caches_match(tcache, jout)

    def test_mixed_matches_sequential_segmented(self, mixed_model):
        # the mixed window against S segmented decode steps (staged, f32
        # dots: the row decode kernel's plain version)
        _, tmp = mixed_model
        cfg = _port_config(CFG4)
        prompts = _prompts(2, 5, 13, CFG4.vocab_size)
        window = _prompts(2, 4, 21, CFG4.vocab_size)
        pos = torch.full((2,), 5, dtype=torch.int32)
        ca, cb = (_port_prefill(tmp, cfg, TL.HeadMajorQuantKVCache.create(
            cfg, 2, 32, device="cpu"), prompts, mixed=True)
            for _ in range(2))
        seq = []
        for i in range(4):
            lg, ca = TM.decode_step_mixed_segmented(tmp, _t(window[:, i]),
                                                    pos + i, ca, cfg)
            seq.append(lg)
        ver, cb = TSP.verify_step_mixed(tmp, _t(window), pos, cb, cfg)
        np.testing.assert_allclose(ver.numpy(), torch.stack(seq, 1).numpy(),
                                   rtol=0, atol=SEQ_LOGIT_ATOL)
        for f in dataclasses.fields(ca):
            np.testing.assert_allclose(
                getattr(ca, f.name).float().numpy(),
                getattr(cb, f.name).float().numpy(), rtol=0,
                atol=SEQ_CACHE_ATOL)

    def test_window_past_the_cache_raises(self, mixed_model):
        # R15: the reference's dynamic_update_slice would clamp this window
        # back over valid K/V; the port refuses it
        config, cfg, _, tp = _target()
        cache = TL.KVCache.create(cfg, 2, 8, device="cpu")
        with pytest.raises(ValueError, match="R15"):
            TSP.verify_step_fused(tp, _t(np.ones((2, 3))),
                                  torch.tensor([5, 6], dtype=torch.int32),
                                  cache, cfg)
        # the last window that fits is served
        TSP.verify_step_fused(tp, _t(np.ones((2, 3))),
                              torch.tensor([5, 4], dtype=torch.int32), cache,
                              cfg)
        # a round checks both caches before the draft writes anything
        dcache = TL.KVCache.create(cfg, 2, 8, device="cpu")
        before = cache.k.clone()
        with pytest.raises(ValueError, match="R15"):
            TSP.spec_decode_round(
                tp, tp, _t([1, 2]), torch.tensor([3, 4], dtype=torch.int32),
                cache, dcache, torch.Generator(), 0.0, 0, 1.0, cfg, cfg,
                gamma=4)
        assert torch.equal(cache.k, before) and not dcache.k.any()
        mcfg = _port_config(CFG4)
        hm = TL.HeadMajorQuantKVCache.create(mcfg, 2, 8, device="cpu")
        with pytest.raises(ValueError, match="R15"):
            TSP.verify_step_mixed(mixed_model[1], _t(np.ones((2, 4))),
                                  torch.tensor([0, 5], dtype=torch.int32),
                                  hm, mcfg)
        with pytest.raises(ValueError, match="HeadMajorQuantKVCache"):
            TSP.verify_step_mixed(
                mixed_model[1], _t(np.ones((2, 2))),
                torch.tensor([0, 0], dtype=torch.int32),
                TL.QuantKVCache.create(mcfg, 2, 8, device="cpu"), mcfg)


class TestAcceptance:
    @pytest.mark.parametrize("seed", range(3))
    def test_matches_reference_on_its_draws(self, seed):
        # the reference's speculative_accept splits its key into the
        # uniforms' and the Gumbel-max draw's; the port takes those draws
        # and must give the same n_acc and next token, exactly. Row 0 is
        # greedy (one-hot p and q), the others sampled.
        B, gamma, V = 6, 4, 16
        kq, kp, kd, ka = jax.random.split(jax.random.PRNGKey(seed), 4)
        q = jax.nn.softmax(jax.random.normal(kq, (B, gamma, V)) * 1.5, -1)
        p = jax.nn.softmax(jax.random.normal(kp, (B, gamma + 1, V)) * 1.5, -1)
        d = jax.random.categorical(kd, jnp.log(q), axis=-1).astype(jnp.int32)
        q = q.at[0].set(jax.nn.one_hot(d[0], V))
        p = p.at[0].set(jax.nn.one_hot(jnp.concatenate([d[0, :2], jnp.asarray(
            [(int(d[0, 2]) + 1) % V, 0, 0])]), V))
        n_acc, nxt = JSP.speculative_accept(d, q, p, ka)
        ku, kr = jax.random.split(ka)
        tn, tx = TSP.speculative_accept_draws(
            _t(d), torch.from_numpy(np.array(q)),
            torch.from_numpy(np.array(p)),
            torch.from_numpy(np.array(jax.random.uniform(ku, (B, gamma)))),
            torch.from_numpy(np.array(jax.random.gumbel(kr, (B, V)))))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(n_acc))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(nxt))
        assert int(tn[0]) == 2 and int(tx[0]) == (int(d[0, 2]) + 1) % V

    def test_greedy_one_hot_reduces_to_prefix_match(self):
        V = 6
        p = torch.nn.functional.one_hot(torch.tensor([2, 4, 1, 3]), V)[None]
        q = torch.nn.functional.one_hot(torch.tensor([2, 4, 0]), V)[None]
        gen = torch.Generator().manual_seed(0)
        n_acc, nxt = TSP.speculative_accept(torch.tensor([[2, 4, 0]]),
                                            q.float(), p.float(), gen)
        assert int(n_acc[0]) == 2 and int(nxt[0]) == 1

    def test_output_marginal_matches_target(self):
        # the first emitted token is distributed as p_0 whatever q is
        # (Leviathan et al. thm. 1), empirically at B = 40000 draws of the
        # port's generator (the reference's bound)
        V, gamma, B = 8, 2, 40000
        gen = torch.Generator().manual_seed(0)
        p_rows = torch.softmax(torch.randn((gamma + 1, V), generator=gen)
                               * 1.5, -1)
        q_rows = torch.softmax(torch.randn((gamma, V), generator=gen) * 1.5,
                               -1)
        d = torch.stack([torch.multinomial(q_rows[i], B, replacement=True,
                                           generator=gen)
                         for i in range(gamma)], dim=1)
        n_acc, nxt = TSP.speculative_accept(
            d, q_rows.expand(B, gamma, V), p_rows.expand(B, gamma + 1, V),
            gen)
        first = torch.where(n_acc >= 1, d[:, 0], nxt.long())
        emp = torch.bincount(first, minlength=V).double() / B
        assert (emp - p_rows[0].double()).abs().max() < 0.012, (emp, p_rows)

    def test_draft_equals_target_accepts_everything(self):
        config, cfg, _, tp = _target()
        B, gamma = 2, 3
        prompts = _prompts(B, 5, 7, config.vocab_size)
        cache = _port_prefill(tp, cfg, TL.KVCache.create(cfg, B, 64,
                                                         device="cpu"),
                              prompts)
        dcache = _port_prefill(tp, cfg, TL.KVCache.create(cfg, B, 64,
                                                          device="cpu"),
                               prompts)
        gen = torch.Generator().manual_seed(3)
        out, n_new, _, new_pos, _, _ = TSP.spec_decode_round(
            tp, tp, _t([9, 10]), torch.full((B,), 5, dtype=torch.int32),
            cache, dcache, gen, torch.full((B,), 0.8), torch.zeros(
                (B,), dtype=torch.int64), torch.ones((B,)), cfg, cfg,
            gamma=gamma)
        assert n_new.tolist() == [gamma + 1] * B
        assert new_pos.tolist() == [5 + gamma + 1] * B
        assert out.shape == (B, gamma + 1)


def _vanilla_greedy(tp, cfg, prompts, n, cache):
    """Greedy decode through the fused prefill and decode step."""
    logits = []
    for b in range(prompts.shape[0]):
        lg, cache = TF.prefill_into_slot_fused(tp, _t(prompts[b:b + 1]), b,
                                               cache, cfg)
        logits.append(lg)
    tok = torch.stack(logits).argmax(-1)
    pos = torch.full((prompts.shape[0],), prompts.shape[1],
                     dtype=torch.int32)
    out = [[int(t)] for t in tok]
    for _ in range(n - 1):
        lg, cache = TF.decode_step_fused(tp, tok, pos, cache, cfg)
        tok, pos = lg.argmax(-1), pos + 1
        for row, t in zip(out, tok.tolist()):
            row.append(t)
    return out


class TestAgainstReference:
    def test_greedy_round(self):
        # one greedy round (gamma 3, a 1-layer early-exit draft) from the
        # reference's prefilled caches: emitted tokens, counts, positions
        # and both caches
        config, cfg, jp, tp = _target()
        jdraft, jdc = JSP.truncate_draft(jp, config, 1)
        tdraft, tdc = TSP.truncate_draft(tp, cfg, 1)
        B, S0 = 2, 5
        jcache = JL.KVCache.create(config, B, 32)
        jdcache = JL.KVCache.create(jdc, B, 32)
        for b, prompt in enumerate(_prompts(B, S0, 11, config.vocab_size)):
            _, jcache = JF.prefill_into_slot_fused(
                jp, jnp.asarray(prompt[None]), jnp.asarray(b), jcache,
                config, interpret=True)
            _, jdcache = JF.prefill_into_slot_fused(
                jdraft, jnp.asarray(prompt[None]), jnp.asarray(b), jdcache,
                jdc, interpret=True)
        tcache = TL.KVCache.create(cfg, B, 32, device="cpu")
        tdcache = TL.KVCache.create(tdc, B, 32, device="cpu")
        pre = [np.array(a) for a in jcache] + [np.array(a) for a in jdcache]
        tokens = np.array([17, 23], np.int32)
        pos = np.full((B,), S0, np.int32)
        zeros = np.zeros((B,), np.float32)
        with _Rounding(fn=JSP.spec_decode_round,
                       static=("config", "draft_config", "gamma", "pad_id",
                               "interpret")) as rec:
            def run_jax():
                out = rec.jax_step(
                    jp, jdraft, jnp.asarray(tokens), jnp.asarray(pos),
                    jcache, jdcache, jax.random.PRNGKey(0), zeros,
                    np.zeros((B,), np.int32), np.ones((B,), np.float32),
                    config, jdc, gamma=3, interpret=True)
                return out

            def run_port():
                _reset(tcache, pre[:2])
                _reset(tdcache, pre[2:])
                out = TSP.spec_decode_round(
                    tp, tdraft, _t(tokens), torch.from_numpy(pos), tcache,
                    tdcache, torch.Generator().manual_seed(0),
                    torch.from_numpy(zeros),
                    torch.zeros((B,), dtype=torch.int64),
                    torch.ones((B,)), cfg, tdc, gamma=3)
                return tuple(t.numpy() for t in out[:4])

            jout, tout, _, _, _ = _replay(rec, run_jax, run_port)
        for a, b in zip(tout, jout[:4]):
            np.testing.assert_array_equal(a, np.asarray(b))
        _assert_caches_match(tcache, jout[4])
        _assert_caches_match(tdcache, jout[5])

    @pytest.mark.parametrize("cache_kind", ["bf16", "quant"])
    def test_generate_greedy(self, cache_kind):
        config, cfg, jp, tp = _target()
        jcls, tcls = _CACHES[cache_kind]
        jdraft, jdc = JSP.truncate_draft(jp, config, 1)
        tdraft, tdc = TSP.truncate_draft(tp, cfg, 1)
        prompts = _prompts(2, 5, 11, config.vocab_size)
        with _Rounding() as rec:
            def run_jax():
                return JSP.generate_speculative(
                    jp, jdraft, jnp.asarray(prompts), 12, config, jdc,
                    gamma=3, cache_factory=jcls.create,
                    draft_cache_factory=jcls.create, interpret=True)

            def run_port():
                return TSP.generate_speculative(
                    tp, tdraft, _t(prompts), 12, cfg, tdc, gamma=3,
                    cache_factory=tcls.create,
                    draft_cache_factory=tcls.create)

            ref, got, first, flips, _ = _replay(rec, run_jax, run_port,
                                                RUN_MAX_FLIPS)
        print(f"\ngenerate {cache_kind}: {flips} codes replayed; tokens "
              f"before the replay {'equal' if first == ref else 'differ'}")
        assert got == ref

    def test_generate_mixed_self_draft(self, mixed_model):
        # the 13B flagship's composition at tiny size: the segmented mixed
        # target with a 2-layer truncate_mixed self-draft, head-major caches
        jmp, tmp = mixed_model
        cfg = _port_config(CFG4)
        jdraft, jdc = JSP.truncate_draft(jmp, CFG4, 2)
        tdraft, tdc = TSP.truncate_draft(tmp, cfg, 2)
        assert isinstance(tdraft, TM.MixedStackedParams)
        for n in TM._PROJ_NAMES:
            assert TM.num_bits_per_layer(getattr(tdraft.layers, n)) == \
                TM.num_bits_per_layer(getattr(tmp.layers, n))[:2]
        prompts = _prompts(2, 5, 13, CFG4.vocab_size)
        with _Rounding() as rec:
            def run_jax():
                return JSP.generate_speculative(
                    jmp, jdraft, jnp.asarray(prompts), 10, CFG4, jdc,
                    gamma=3, cache_factory=JL.HeadMajorQuantKVCache.create,
                    draft_cache_factory=JL.HeadMajorQuantKVCache.create,
                    interpret=True)

            def run_port():
                return TSP.generate_speculative(
                    tmp, tdraft, _t(prompts), 10, cfg, tdc, gamma=3,
                    cache_factory=TL.HeadMajorQuantKVCache.create,
                    draft_cache_factory=TL.HeadMajorQuantKVCache.create)

            ref, got, _, _, _ = _replay(rec, run_jax, run_port,
                                        RUN_MAX_FLIPS)
        assert got == ref


class TestPortRelations:
    @pytest.mark.parametrize("cache_kind", ["bf16", "quant"])
    def test_spec_equals_vanilla_greedy(self, cache_kind):
        # over the token-major caches the verify step and the decode step
        # attend alike, so greedy speculative output is the greedy stream,
        # even with a weak (1-layer early-exit) draft (R16: not claimed over
        # the head-major cache, whose decode step attends through rows 10
        # and 11)
        config, cfg, _, tp = _target()
        tcls = _CACHES[cache_kind][1]
        prompts = _prompts(2, 5, 11, config.vocab_size)
        draft, dcfg = TSP.truncate_draft(tp, cfg, 1)
        ref = _vanilla_greedy(tp, cfg, prompts, 12,
                              tcls.create(cfg, 2, 40, device="cpu"))
        out = TSP.generate_speculative(tp, draft, _t(prompts), 12, cfg, dcfg,
                                       gamma=3, cache_factory=tcls.create,
                                       draft_cache_factory=tcls.create)
        assert out == ref

    def test_adversarial_draft_still_exact(self):
        # a draft that never matches (shuffled embedding rows) costs
        # acceptance, not correctness
        config, cfg, _, tp = _target()
        prompts = _prompts(1, 4, 21, config.vocab_size)
        perm = torch.from_numpy(np.random.default_rng(5).permutation(
            config.vocab_size))
        draft = dataclasses.replace(tp, embed=tp.embed[perm])
        ref = _vanilla_greedy(tp, cfg, prompts, 8,
                              TL.KVCache.create(cfg, 1, 64, device="cpu"))
        out = TSP.generate_speculative(tp, draft, _t(prompts), 8, cfg, cfg,
                                       gamma=2)
        assert out == ref

    def test_finished_rows_stay_in_the_cache(self, monkeypatch):
        # a row that accepts every proposal finishes rounds ahead of a row
        # that accepts none; its later rounds (dropped) rewrite the cache's
        # last columns instead of running past them
        config, cfg, _, tp = _target()
        gamma, N, seen = 3, 6, []

        def fake_round(params, draft, tokens, pos, cache, dcache, gen, *a,
                       gamma, **kw):
            seen.append(pos.tolist())
            TSP._check_window(pos, gamma + 1, cache.k.shape[2])
            n_new = torch.tensor([gamma + 1, 1])
            out = torch.full((2, gamma + 1), 7, dtype=tokens.dtype)
            return out, n_new, tokens, pos + n_new, cache, dcache

        monkeypatch.setattr(TSP, "spec_decode_round", fake_round)
        out = TSP.generate_speculative(tp, tp, _t(_prompts(2, 4, 5, 256)), N,
                                       cfg, cfg, gamma=gamma)
        max_len = 4 + N + 2 * (gamma + 1)
        assert [len(o) for o in out] == [N, N] and len(seen) == N - 1
        assert seen[-1] == [max_len - gamma - 1, 4 + N - 2]

    def test_truncate_draft_shapes(self, mixed_model):
        config, cfg, _, tp = _target()
        draft, dcfg = TSP.truncate_draft(tp, cfg, 1)
        assert dcfg.num_layers == 1
        assert draft.layers.qkv.packed.shape[0] == 1
        assert draft.layers.attn_norm.shape[0] == 1
        assert all(t.shape[0] == 1 for t in draft.layers.qkv.L_scales)
        assert draft.layers.qkv.packed._base is tp.layers.qkv.packed
        dense = TL.init_params(1, cfg, device="cpu")
        ddense, dcfg = TSP.truncate_draft(dense, cfg, 1)
        assert len(ddense.layers) == 1 and dcfg.num_layers == 1
        mdraft, mcfg = TSP.truncate_draft(mixed_model[1],
                                          _port_config(CFG4), 3)
        assert mcfg.num_layers == 3
        assert TM.num_bits_per_layer(mdraft.layers.q_proj) == [4, 2, 2]

    def test_sampled_generation_runs(self):
        config, cfg, _, tp = _target()
        draft, dcfg = TSP.truncate_draft(tp, cfg, 1)
        out = TSP.generate_speculative(
            tp, draft, _t(_prompts(2, 4, 13, config.vocab_size)), 6, cfg,
            dcfg, gamma=2, temperature=0.9, top_k=20,
            generator=torch.Generator().manual_seed(7))
        assert all(len(o) == 6 for o in out)
        assert all(0 <= t < config.vocab_size for o in out for t in o)


def _requests(n=3, max_new=10, seed=31, **kw):
    vocab = _params("tiny")[0].vocab_size
    rng = np.random.default_rng(seed)
    return [TE.Request(uid=i, prompt=rng.integers(1, vocab, 4 + i).astype(
        np.int32), max_new_tokens=max_new, **kw) for i in range(n)]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return {c.uid: (c.tokens, c.finished_reason) for c in engine.run()}


def _spec_engine(draft, dcfg, **kw):
    _, cfg, _, tp = _target()
    return TSE.SpeculativeServingEngine(tp, draft, cfg, dcfg, device="cpu",
                                        **dict(dict(gamma=3, max_slots=2,
                                                    max_seq_len=64), **kw))


class TestSpecEngine:
    def _fast(self, **kw):
        _, cfg, _, tp = _target()
        return TFE.FastServingEngine(tp, cfg, max_slots=2, max_seq_len=64,
                                     device="cpu", **kw)

    def test_greedy_engine_matches_fast_engine(self):
        _, cfg, _, tp = _target()
        draft, dcfg = TSP.truncate_draft(tp, cfg, 1)
        ref = _run(self._fast(), _requests())
        eng = _spec_engine(draft, dcfg)
        assert _run(eng, _requests()) == ref
        assert eng.spec_rounds > 0

    def test_int8_caches(self):
        # an int8 token-major target cache and an int8 draft cache
        _, cfg, _, tp = _target()
        draft, dcfg = TSP.truncate_draft(tp, cfg, 1)
        ref = _run(self._fast(kv_int8=True), _requests(n=2))
        eng = _spec_engine(draft, dcfg, kv_int8=True, draft_kv_int8=True)
        assert isinstance(eng.draft_cache, TL.QuantKVCache)
        assert _run(eng, _requests(n=2)) == ref

    def test_eos_mid_window(self):
        # an EOS accepted mid-window ends the request at the EOS token and
        # drops the rest of the window
        _, cfg, _, tp = _target()
        [(tokens, _)] = _run(self._fast(), _requests(n=1, max_new=12)
                             ).values()
        eos = tokens[3]
        draft, dcfg = TSP.truncate_draft(tp, cfg, 1)
        got = _run(_spec_engine(draft, dcfg, max_slots=1),
                   _requests(n=1, max_new=12, eos_token=int(eos)))
        assert got == {0: (tokens[:tokens.index(eos) + 1], "eos")}

    def test_acceptance_stats_perfect_draft(self):
        _, cfg, _, tp = _target()
        eng = _spec_engine(tp, cfg, gamma=2, adaptive=False)
        _run(eng, _requests(n=2, max_new=9))
        # a perfect draft accepts every proposal of every round
        assert eng.accepted_tokens == eng.spec_rounds * 2

    def test_adaptive_disables_on_zero_acceptance(self):
        # a draft cut from other random weights: greedy acceptance ~0. The
        # adaptive engine keeps the exact greedy stream and turns
        # speculation off, so most ticks are plain decode steps
        _, cfg, _, tp = _target()
        other = TF.quantize_factors_int8_fused(TF.fuse_stacked(
            bench_params.build_compressed_llama_params(
                cfg, rank=16, seed=99, device="cpu")))
        bad, dcfg = TSP.truncate_draft(other, cfg, 1)
        ref = _run(self._fast(), _requests(n=2, max_new=12))
        eng = _spec_engine(bad, dcfg, probe_every=50)
        assert _run(eng, _requests(n=2, max_new=12)) == ref
        assert eng.gamma_current == 0
        assert eng.accept_ewma is not None and eng.accept_ewma < 0.1
        assert eng.spec_rounds < eng.tokens_generated / 2

    def test_adaptive_probe_resyncs_the_draft(self):
        # plain ticks keep the draft cache current, and a probe round every
        # probe_every ticks re-measures: a perfect draft switched off by
        # hand comes back on at the first probe, and the stream stays exact
        _, cfg, _, tp = _target()
        ref = _run(self._fast(), _requests(n=2, max_new=12))
        eng = _spec_engine(tp, cfg, gamma=2, probe_every=3,
                           draft_cost=0.1)
        eng.gamma_current, eng.accept_ewma = 0, 0.0
        assert _run(eng, _requests(n=2, max_new=12)) == ref
        assert eng.gamma_current > 0 and eng.spec_rounds > 0

    def test_adaptive_keeps_gamma_on_good_draft(self):
        _, cfg, _, tp = _target()
        eng = _spec_engine(tp, cfg, gamma=2, draft_cost=0.1)
        _run(eng, _requests(n=2, max_new=9))
        assert eng.gamma_current == 2 and eng.accept_ewma > 0.9

    def test_validation(self):
        _, cfg, _, tp = _target()
        draft, dcfg = TSP.truncate_draft(tp, cfg, 1)
        eng = _spec_engine(draft, dcfg, max_seq_len=24)
        # the gamma columns of headroom the verify window writes (R15)
        with pytest.raises(ValueError, match="gamma 3 headroom"):
            eng.submit(TE.Request(uid=0, prompt=np.arange(1, 11),
                                  max_new_tokens=12))
        eng.submit(TE.Request(uid=1, prompt=np.arange(1, 10),
                              max_new_tokens=12))
        assert len(_run(eng, [])[1][0]) == 12
        with pytest.raises(ValueError, match="prefill_chunk"):
            _spec_engine(draft, dcfg, prefill_chunk=8)
        stacked = bench_params.build_compressed_llama_params(
            cfg, rank=4, device="cpu")
        with pytest.raises(ValueError, match="fused"):
            TSE.SpeculativeServingEngine(stacked, draft, cfg, dcfg,
                                         device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                TSE.SpeculativeServingEngine(tp, draft, cfg, dcfg)
