"""PyTorch port, ``serve/engine.py`` and ``serve/fast_engine.py``, against
the JAX reference's ``FastServingEngine`` (Pallas kernels in interpret
mode).

Both engines serve the same seeded greedy requests on the same fused
params. Every int8 rounding of both whole runs is recorded; where the port
rounds a code the other way at a knife edge, the port's run is replayed
with the reference's code there (``tests/test_torch_fused.py::_replay``),
and then the completions must be equal."""

import dataclasses

import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.serve import engine as JE
from ee274_convexcaldera_llm_quantization_tpu.serve import fast_engine as JFE
from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused as TF
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import engine as TE
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
    fast_engine as TFE)

from test_torch_fused import (  # noqa: F401 (a fixture)
    _Rounding, _one_torch_thread, _params, _port_config, _replay)

# a whole engine run (4 prefills, ~12 decode ticks) may replay more codes
# than one call; 2 were replayed over these three runs
ENGINE_MAX_FLIPS = 64


def _requests(seed, vocab, n=4, new_tokens=5):
    rng = np.random.default_rng(seed)
    return [dict(uid=uid, prompt=rng.integers(0, vocab, size=int(
        rng.integers(3, 13))).astype(np.int32), max_new_tokens=new_tokens)
            for uid in range(n)]


def _serve(engine, reqs, request_cls):
    for r in reqs:
        engine.submit(request_cls(**r))
    done = engine.run()
    return sorted((c.uid, list(map(int, c.tokens)), c.finished_reason)
                  for c in done)


@pytest.mark.parametrize("max_seq_len,chunk,slots", [
    (32, 0, 2), (1024, 0, 2), (32, 8, 1)])
def test_completions_match_reference(max_seq_len, chunk, slots):
    # four requests over fewer slots, which are freed and reused; 32
    # decodes with the row kernel, 1024 with the all-batch kernel's
    # partition. Chunked prefill (prompts of one and two 8-token chunks)
    # runs on one slot: with a live neighbour, the reference's decode
    # overwrites a half-prefilled prompt (ROADMAP R7; see
    # test_chunked_prefill_survives_a_live_neighbour)
    config, jparams, tparams = _params("tiny")
    reqs = _requests(7 + max_seq_len + chunk, config.vocab_size)
    kw = dict(max_slots=slots, max_seq_len=max_seq_len, flash_attn=True,
              prefill_chunk=chunk)
    with _Rounding() as rec:
        def run_jax():
            eng = JFE.FastServingEngine(jparams, config, interpret=True,
                                        **kw)
            assert eng._attn_kernel == ("ab" if max_seq_len >= 1024
                                        else "row")
            return _serve(eng, reqs, JE.Request)

        def run_port():
            eng = TFE.FastServingEngine(tparams, _port_config(config),
                                        device="cpu", **kw)
            assert eng._attn_kernel == ("ab" if max_seq_len >= 1024
                                        else "row")
            return _serve(eng, reqs, TE.Request)

        ref, got, first, flips, _ = _replay(rec, run_jax, run_port,
                                            ENGINE_MAX_FLIPS)
    print(f"\nengine max_seq_len={max_seq_len} chunk={chunk}: {flips} codes "
          f"replayed; completions before the replay "
          f"{'equal' if first == ref else 'differ'}")
    assert len(ref) == len(reqs)
    assert got == ref


@pytest.mark.parametrize("staged", [True, False])
def test_chunked_prefill_survives_a_live_neighbour(staged):
    # A 20-token prompt in 8-token chunks while another request decodes:
    # between its chunks the half-prefilled slot is not live, yet the
    # decode step writes a dummy K/V row for it. The reference writes it at
    # position 0, over the prompt's first token, and the prompt's tokens
    # change (ROADMAP R7); the port writes it where the next chunk writes.
    _, _, tparams = _params("tiny")
    cfg = _port_config(_params("tiny")[0])
    rng = np.random.default_rng(3)
    short = rng.integers(0, cfg.vocab_size, size=4)
    long = rng.integers(0, cfg.vocab_size, size=20)

    def run(reqs):
        eng = TFE.FastServingEngine(tparams, cfg, max_slots=2,
                                    max_seq_len=32, flash_attn=True,
                                    prefill_chunk=8, staged_kv=staged,
                                    device="cpu")
        return {c.uid: c.tokens for c in _serve_raw(eng, reqs)}

    alone = run([TE.Request(uid=1, prompt=long, max_new_tokens=6)])
    beside = run([TE.Request(uid=0, prompt=short, max_new_tokens=8),
                  TE.Request(uid=1, prompt=long, max_new_tokens=6)])
    assert beside[1] == alone[1]


def _serve_raw(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return engine.run()


def test_decode_tick_is_the_staged_step():
    # A/B contract: the engine's decode tick equals a direct
    # decode_step_fused(staged_kv=True) call bit for bit (same code path),
    # so kernel changes plumbed through decode_step_fused reach serving
    _, _, tparams = _params("tiny")
    cfg = _port_config(_params("tiny")[0])
    rng = np.random.default_rng(7)
    eng = TFE.FastServingEngine(tparams, cfg, max_slots=2, max_seq_len=32,
                                flash_attn=True, device="cpu")
    assert eng._staged is True
    for uid in range(2):
        eng.submit(TE.Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, size=4 + 3 * uid), max_new_tokens=4))
    eng._admit()
    tokens, pos = eng._batch()
    snap = dataclasses.replace(
        eng.cache, **{f.name: getattr(eng.cache, f.name).clone()
                      for f in dataclasses.fields(eng.cache)})
    eng._decode()
    ref_logits, ref_cache = TF.decode_step_fused(
        tparams, tokens, pos, snap, cfg, staged_kv=True)
    exp = {s: int(t) for s, t in enumerate(ref_logits.argmax(-1))
           if s in eng.slots}
    assert {s: st.generated[-1] for s, st in eng.slots.items()} == exp
    for f in dataclasses.fields(ref_cache):
        assert torch.equal(getattr(eng.cache, f.name),
                           getattr(ref_cache, f.name)), f.name


@pytest.mark.parametrize("kw,cache_cls", [
    (dict(flash_attn=True), TL.HeadMajorQuantKVCache),
    (dict(kv_int8=True), TL.QuantKVCache), (dict(), TL.KVCache)])
def test_cache_per_mode(kw, cache_cls):
    _, _, tparams = _params("tiny")
    cfg = _port_config(_params("tiny")[0])
    eng = TFE.FastServingEngine(tparams, cfg, max_slots=2, max_seq_len=16,
                                device="cpu", **kw)
    assert type(eng.cache) is cache_cls
    assert eng.cache.k.shape[:2] == (cfg.num_layers, 2)
    eng.submit(TE.Request(uid=0, prompt=np.arange(1, 6), max_new_tokens=3,
                          temperature=0.9, top_k=4))
    (done,) = eng.run()
    assert done.finished_reason == "length" and len(done.tokens) == 3


def test_eos_and_validation():
    _, _, tparams = _params("tiny")
    cfg = _port_config(_params("tiny")[0])
    eng = TFE.FastServingEngine(tparams, cfg, max_slots=1, max_seq_len=16,
                                flash_attn=True, device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(TE.Request(uid=0, prompt=np.arange(12), max_new_tokens=5))
    eng.submit(TE.Request(uid=1, prompt=np.arange(1, 5), max_new_tokens=8))
    (free_run,) = eng.run()
    eos = free_run.tokens[1]
    eng.submit(TE.Request(uid=2, prompt=np.arange(1, 5), max_new_tokens=8,
                          eos_token=eos))
    assert eng.busy()
    (stopped,) = eng.run()
    assert stopped.finished_reason == "eos"
    assert stopped.tokens == free_run.tokens[:free_run.tokens.index(eos) + 1]
    assert not eng.busy() and eng.live_generated() == {}
    assert [TE.ServingEngine._bucket(n) for n in (1, 8, 9, 300)] == [
        8, 8, 16, 512]


def test_unported_options_raise():
    _, _, tparams = _params("tiny")
    cfg = _port_config(_params("tiny")[0])
    with pytest.raises(NotImplementedError, match="Queue B item 12"):
        TFE.FastServingEngine(tparams, cfg, mlp_kernel=True, device="cpu")
    # unfused stacked params serve without flash attention or chunked
    # prefill (tests/test_torch_engines.py); those options need fused ones
    stacked = bench_params.build_compressed_llama_params(cfg, rank=4,
                                                         device="cpu")
    with pytest.raises(ValueError, match="fused"):
        TFE.FastServingEngine(stacked, cfg, flash_attn=True, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        TFE.FastServingEngine(stacked, cfg, prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="flash_attn"):
        TFE.FastServingEngine(object(), cfg, max_slots=2, max_seq_len=16,
                              flash_attn=True, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        TFE.FastServingEngine(tparams, cfg, max_seq_len=20, prefill_chunk=8,
                              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TFE.FastServingEngine(tparams, cfg, max_slots=1, max_seq_len=8)
