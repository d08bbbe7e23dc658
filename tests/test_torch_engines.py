"""PyTorch port, the unfused serving and evaluation paths against the JAX
reference: ``ServingEngine`` on per-layer ``llama.ModelParams`` (grouped and
w4a8), ``FastServingEngine`` on unfused w4a8 ``StackedModelParams`` (bf16
and int8 caches), and ``evaluate_perplexity``.

Params are those of ``tests/test_torch_model.py``. Engines serve the same
seeded greedy requests on both sides; on the w4a8 paths every int8 rounding
of both whole runs is recorded and the port's run is replayed at each
knife edge (``tests/test_torch_fused.py::_replay``) before the completions
are held equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.evalm import perplexity as JP
from ee274_convexcaldera_llm_quantization_tpu.serve import engine as JE
from ee274_convexcaldera_llm_quantization_tpu.serve import fast_engine as JFE
from ee274_convexcaldera_llm_quantization_tpu_torch.evalm import (
    perplexity as TP)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import engine as TE
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
    fast_engine as TFE)

from test_torch_fused import (  # noqa: F401 (a fixture)
    _Rounding, _one_torch_thread, _port_config, _replay)
from test_torch_model import _model, _stacked

# a whole engine run (4 prefills, ~10 decode ticks) may replay more codes
# than one call (tests/test_torch_serve.py)
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


def _both(make_jax, make_port, reqs, replay):
    """(reference completions, port completions, reading)."""
    def run_jax():
        return _serve(make_jax(), reqs, JE.Request)

    def run_port():
        return _serve(make_port(), reqs, TE.Request)

    if not replay:
        return run_jax(), run_port(), "no int8 rounding"
    with _Rounding() as rec:
        ref, got, first, flips, _ = _replay(rec, run_jax, run_port,
                                            ENGINE_MAX_FLIPS)
    return ref, got, (f"{flips} codes replayed; completions before the "
                      f"replay {'equal' if first == ref else 'differ'}")


@pytest.mark.parametrize("mode", ["grouped", "w4a8"])
def test_serving_engine_matches_reference(mode):
    # four requests over two slots, which are freed and reused: prefill in
    # power-of-two buckets (llama.prefill_into_slot), ticks through
    # llama.decode_step_batched, a bf16 cache
    config, jp, tp = _model("tiny", mode)
    reqs = _requests(11, config.vocab_size)
    kw = dict(max_slots=2, max_seq_len=32)
    ref, got, reading = _both(
        lambda: JE.ServingEngine(jp, config, use_pallas=False, **kw),
        lambda: TE.ServingEngine(tp, _port_config(config), device="cpu",
                                 **kw),
        reqs, mode == "w4a8")
    print(f"\nServingEngine {mode}: {reading}")
    assert len(ref) == len(reqs)
    assert got == ref


@pytest.mark.parametrize("kv_int8", [False, True])
def test_unfused_fast_engine_matches_reference(kv_int8):
    # FastServingEngine on stacked w4a8 params: prefill_into_slot_w4a8 and
    # decode_step_w4a8 (the reference on its stacked W4A8 Pallas kernel,
    # interpret mode)
    config, js, ts = _stacked("tiny", "w4a8")
    reqs = _requests(12 + kv_int8, config.vocab_size)
    kw = dict(max_slots=2, max_seq_len=32, kv_int8=kv_int8)
    ref, got, reading = _both(
        lambda: JFE.FastServingEngine(js, config, interpret=True, **kw),
        lambda: TFE.FastServingEngine(ts, _port_config(config),
                                      device="cpu", **kw),
        reqs, True)
    print(f"\nFastServingEngine unfused kv_int8={kv_int8}: {reading}")
    assert len(ref) == len(reqs)
    assert got == ref


def test_engine_caches_and_rules():
    config, _, tp = _model("tiny", "grouped")
    cfg = _port_config(config)
    eng = TE.ServingEngine(tp, cfg, max_slots=2, max_seq_len=16,
                           device="cpu")
    assert type(eng.cache) is TL.KVCache
    assert eng.cache.k.shape[:3] == (cfg.num_layers, 2, 16)
    eng.submit(TE.Request(uid=0, prompt=np.arange(1, 6), max_new_tokens=3,
                          temperature=0.9, top_k=4))
    (done,) = eng.run()
    assert done.finished_reason == "length" and len(done.tokens) == 3
    _, _, ts = _stacked("tiny", "w4a8")
    fast = TFE.FastServingEngine(ts, cfg, max_slots=2, max_seq_len=16,
                                 kv_int8=True, device="cpu")
    assert type(fast.cache) is TL.QuantKVCache
    _, _, tg = _stacked("tiny", "grouped")
    with pytest.raises(ValueError, match="w4a8"):
        TFE.FastServingEngine(tg, cfg, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        TFE.FastServingEngine(ts, cfg, flash_attn=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TE.ServingEngine(tp, cfg, max_slots=1, max_seq_len=8)
        with pytest.raises(RuntimeError, match="cuda"):
            TP.evaluate_perplexity(tp, np.arange(64), cfg, window=16)


# The w4a8 path's int8 roundings are replayed, and its perplexity then
# agrees to 0 (bound rel 1e-4). The grouped path has only bf16 roundings,
# which the replay does not cover: an f32 ulp of another summation order
# flips a bf16 cast now and then (tests/test_torch_model.py, GROUPED_REL),
# and the perplexity moved by 0 to 2.39e-4 relative over six seeded
# streams and two window sizes (PERF.md, CPU tests): its bound is 4x the
# largest reading.
PPL_REL = {"grouped": 1e-3, "w4a8": 1e-4}


class _TpOnlyMesh:
    """A device mesh's dim names, with no "dp" dim."""
    mesh_dim_names = ("tp",)


@pytest.mark.parametrize("mode", ["grouped", "w4a8"])
def test_evaluate_perplexity_matches_reference(mode):
    # five 16-token windows in batches of two (the last batch padded); the
    # grouped path over six seeded streams, the w4a8 path over one
    config, jp, tp = _model("tiny", mode)
    kw = dict(window=16, batch_size=2)
    readings = []
    for seed in range(13, 19 if mode == "grouped" else 14):
        stream = np.random.default_rng(seed).integers(
            0, config.vocab_size, size=90).astype(np.int32)
        if mode == "grouped":
            ref = JP.evaluate_perplexity(jp, stream, config, **kw)
            got = TP.evaluate_perplexity(tp, stream, _port_config(config),
                                         device="cpu", **kw)
        else:
            with _Rounding(JP._window_nll, static=(
                    "config", "use_pallas", "interpret")) as rec:
                ref, got, _, _, _ = _replay(
                    rec,
                    lambda: JP.evaluate_perplexity(jp, stream, config, **kw),
                    lambda: TP.evaluate_perplexity(
                        tp, stream, _port_config(config), device="cpu",
                        **kw),
                    ENGINE_MAX_FLIPS)
        rel = abs(got - ref) / ref
        readings.append(f"{rel:.2e}")
        assert np.isfinite(got) and rel <= PPL_REL[mode], (seed, rel)
    print(f"\nperplexity {mode}: rel difference per stream "
          f"{', '.join(readings)} (bound {PPL_REL[mode]:g})")
    # a mesh without the batch axis is refused before any collective (the
    # sharded harness itself: tests/test_torch_pp.py)
    with pytest.raises(ValueError, match="no dim 'dp'"):
        TP.evaluate_perplexity(tp, stream, _port_config(config),
                               device="cpu", mesh=_TpOnlyMesh(), **kw)
