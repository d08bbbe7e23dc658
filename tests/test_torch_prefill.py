"""PyTorch port, ``prefill_into_slot_fused`` and ``prefill_chunk_fused``
against the JAX reference (Pallas kernels in interpret mode), on the
head-major int8, token-major int8 and bf16 caches.

Params and the rounding replay are those of ``tests/test_torch_fused.py``:
each call starts both programs from the reference's cache, every int8
rounding is recorded on both sides, and a code the port rounds the other
way at a knife edge is replayed with the reference's code before the call
is held to the tight bound. A prefill writes its whole bucket, so the K/V
of the pad tokens past the prompt are compared too."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ee274_convexcaldera_llm_quantization_tpu.models import fused as JF
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused as TF

from test_torch_fused import (  # noqa: F401 (a fixture)
    FLIP_LOGIT_REL, LOGIT_ATOL, LOGIT_RTOL, _CACHES, _Rounding,
    _assert_caches_match, _one_torch_thread, _params, _port_config, _rel,
    _replay, _reset)

SEEDS = range(8)
B, T = 2, 32
# A prefill or a chunk rounds S x layers rows at once, so more codes sit on
# a knife edge than in one decode step: up to 18 codes replayed in one
# 16-token prefill and 36 in one 8-token chunk over these seeds (tiny-mha).
PREFILL_MAX_FLIPS = 64
# K/V scales: a bf16 cast before a factor dot rounds on its own edges,
# which the replay does not cover; over these seeds it moved one scale by
# 2.35e-4 relative (a chunk on tiny-mha), above the decode step's 2e-4.
PREFILL_SCALE_RTOL = 5e-4
# A bf16 cache stores each K/V value rounded to bf16, and a chunk reads its
# own and earlier chunks' values back: a value one bf16 ulp away (an f32
# ulp upstream, not a replayed rounding) moved a later activation by up to
# 0.158 of a code before its int8 rounding (tiny-mha), so the flips a chunk
# on the bf16 cache replays are held to 0.25 of a code, not 0.05.
BF16_CHUNK_RATIO_TOL = 0.25


def _check(jout, tl, first):
    jl, jcache = jout
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl, jl, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert tl.argmax() == jl.argmax()
    assert _rel(first, jl) <= FLIP_LOGIT_REL, _rel(first, jl)
    return jl, jcache


def _call_both(rec, params, jcache, tcache, jkw, port_fn, tkw,
               ratio_tol=None):
    """One reference call (``rec.jax_step``) and one port call from the
    same cache, replayed at rounding flips; returns the reference cache and
    a reading."""
    config, jparams, tparams = params
    pre = [np.array(a) for a in jcache]

    def run_jax():
        return rec.jax_step(jparams, cache=jcache, config=config,
                            interpret=True, **jkw)

    def run_port():
        _reset(tcache, pre)
        return port_fn(tparams, cache=tcache, config=_port_config(config),
                       **tkw)[0].numpy()

    jout, tl, first, flips, ratio = _replay(rec, run_jax, run_port,
                                            PREFILL_MAX_FLIPS, ratio_tol)
    jl, jcache = _check(jout, tl, first)
    _assert_caches_match(tcache, jcache, PREFILL_SCALE_RTOL)
    return jcache, (flips, _rel(first, jl), _rel(tl, jl), ratio,
                    _cache_reading(tcache, jcache))


def _cache_reading(tcache, jcache):
    """The caches' largest difference after the replay: K/V scales
    (relative) for the int8 caches; for bf16, K/V values beyond one bf16
    ulp (absolute, what ``_assert_caches_match``'s atol must cover)."""
    if hasattr(tcache, "k_scale"):
        return "scales", max(
            float(np.max(np.abs(getattr(tcache, n).numpy() - b)
                         / np.maximum(np.abs(b), 1e-30)))
            for n in ("k_scale", "v_scale")
            for b in [np.asarray(getattr(jcache, n))])
    return "values beyond one ulp", max(
        float(np.max(np.abs(getattr(tcache, n).float().numpy() - b)
                     - 2 ** -7 * np.abs(b)))
        for n in ("k", "v")
        for b in [np.asarray(getattr(jcache, n), np.float32)])


def _reading(r):
    return (f"{r[0]} codes replayed (largest value difference {r[3]:.3f} "
            f"of a code), logits {r[1]:.2e} before, {r[2]:.2e} after; "
            f"cache {r[4][0]} differ by {r[4][1]:.2e}")


def _prompt(seed, config, lo, hi):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(lo, hi + 1))
    return rng.integers(0, config.vocab_size, size=n).astype(np.int32)


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("cache", ["head", "quant", "bf16"])
@pytest.mark.parametrize("name", ["tiny", "tiny-mha"])
def test_prefill_into_slot_matches_reference(name, cache, flash):
    # a prompt of 3..16 tokens right-padded with token 0 to the 16-token
    # bucket, into slot seed % 2; logits at the prompt's last position
    params = _params(name)
    config = params[0]
    jcls, tcls = _CACHES[cache]
    readings = []
    with _Rounding(JF.prefill_into_slot_fused,
                   static=("config", "interpret", "flash")) as rec:
        for seed in SEEDS:
            prompt = _prompt(seed, config, 3, 16)
            padded = np.zeros((1, 16), np.int32)
            padded[0, :len(prompt)] = prompt
            slot, last = seed % B, len(prompt) - 1
            jcache = jcls.create(config, B, T)
            tcache = tcls.create(_port_config(config), B, T, device="cpu")
            _, r = _call_both(
                rec, params, jcache, tcache,
                dict(tokens=jnp.asarray(padded), slot=jnp.asarray(slot),
                     last_pos=jnp.asarray(last), flash=flash),
                TF.prefill_into_slot_fused,
                dict(tokens=torch.from_numpy(padded.astype(np.int64)),
                     slot=slot, last_pos=last, flash=flash))
            readings.append(f"seed {seed} (n {len(prompt)}): "
                            + _reading(r))
    print(f"\nprefill {name} cache={cache} flash={flash}:\n  "
          + "\n  ".join(readings))


@pytest.mark.parametrize("cache", ["head", "quant", "bf16"])
@pytest.mark.parametrize("name", ["tiny", "tiny-mha"])
def test_prefill_chunks_match_reference(name, cache):
    # a prompt of 9..16 tokens in two 8-token chunks (the second padded),
    # each chunk from the reference's cache after the first
    params = _params(name)
    config = params[0]
    jcls, tcls = _CACHES[cache]
    C = 8
    readings = []
    with _Rounding(JF.prefill_chunk_fused,
                   static=("config", "interpret")) as rec:
        for seed in SEEDS:
            prompt = _prompt(seed, config, 9, 16)
            n, slot = len(prompt), seed % B
            jcache = jcls.create(config, B, T)
            tcache = tcls.create(_port_config(config), B, T, device="cpu")
            for off in (0, C):
                chunk = np.zeros((1, C), np.int32)
                part = prompt[off:off + C]
                chunk[0, :len(part)] = part
                last = n - 1 - off if off + C >= n else 0
                jcache, r = _call_both(
                    rec, params, jcache, tcache,
                    dict(tokens=jnp.asarray(chunk), slot=jnp.asarray(slot),
                         offset=jnp.asarray(off),
                         last_pos=jnp.asarray(last)),
                    TF.prefill_chunk_fused,
                    dict(tokens=torch.from_numpy(chunk.astype(np.int64)),
                         slot=slot, offset=off, last_pos=last),
                    BF16_CHUNK_RATIO_TOL if cache == "bf16" else None)
                readings.append(f"seed {seed} (n {n}) chunk @{off}: "
                                + _reading(r))
    print(f"\nchunked prefill {name} cache={cache}:\n  "
          + "\n  ".join(readings))
