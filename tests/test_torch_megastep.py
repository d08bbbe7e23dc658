"""PyTorch port, the whole-step decode megakernel (``ops/megastep.py``) and
its model path (``models/persistent.py``) against the JAX reference (its
Pallas kernel in interpret mode), on the reference's tiny MHA model with
rank-128 int8 factors on factor path "l".

The megakernel rounds to int8 inside (the attention and MLP norms' outputs,
the current token's K and V, the attention output, and ``bf16(m)`` before
the down projection). The recorder of ``tests/test_torch_fused.py`` records
those codes on both sides, the reference's from inside its kernel, and a
knife-edge flip is replayed with the reference's code before the bound. The
reference's interpret-mode megastep takes seconds per call on the CPU, so
the file makes six such calls."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ee274_convexcaldera_llm_quantization_tpu.models import llama as JL
from ee274_convexcaldera_llm_quantization_tpu.models import persistent as JP
from ee274_convexcaldera_llm_quantization_tpu.ops import megastep as JM
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused as TF
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    persistent as TP)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import megastep as TM

from test_torch_factor_paths import FACTOR_LOGIT_REL, FACTOR_MAX_FLIPS
from test_torch_fused import (  # noqa: F401 (a fixture)
    LOGIT_RTOL, _Rounding, _assert_caches_match, _one_torch_thread, _params,
    _port_config, _rel, _replay, _reset)

# A replayed flip's values before rounding, in codes. The codes of bf16(m)
# round float(bf16(m)) / scale, and bf16(m) sits on rounding edges of its
# own that the replay does not reach: one bf16 spacing of a value is at most
# 2^-7 of it, so up to 127 x 2^-7 = 0.99 of a code near the row's absmax
# (0.34 read). The other roundings keep tests/test_torch_factor_paths.py's
# FACTOR_RATIO_TOL (0.15); the replay takes one tolerance for a call.
MEGA_RATIO_TOL = 1.0


class _MegaRounding(_Rounding):
    """The recorder with the megakernel's roundings. ``_megastep_kernel`` is
    wrapped so that, after the program that rounds, it reports the codes
    and the values / scale: at ``p_pre`` and ``p_mlp`` the norm's int8
    activations (the normed values recomputed as the kernel computes them),
    at ``p_rope`` the current token's K then V codes (K rotated again as the
    kernel rotates it), at ``p_fin`` the attention output's codes, at
    ``p_dq`` the codes of ``bf16(m)``. The reports carry (layer, program)
    and join the record in that order after the kernel, as the port's plain
    version makes the same roundings layer by layer. Where the replay cannot
    reach (the bf16 casts of y and xr before the factor dots, and bf16(m)
    before the down R dot), the steps are held to the FACTOR_* bounds of
    tests/test_torch_factor_paths.py."""

    def _mega_body(self, orig):
        names = list(inspect.signature(orig).parameters)

        def body(*args, **kw):
            orig(*args, **kw)
            ref = dict(zip(names, args))
            P, eps = kw["plan"], kw["eps"]
            layer, prog = pl.program_id(0), pl.program_id(1)

            def report(sub, codes, ratio):
                jax.debug.callback(
                    lambda l, p, c, r: self.pending.append(
                        ((int(l), int(p), sub), np.array(c), np.array(r))),
                    layer, prog, codes, ratio, ordered=False)

            def normed(norm_ref):
                x = ref["x_ref"][:]
                var = jnp.mean(x * x, axis=1, keepdims=True)
                return x * jax.lax.rsqrt(var + eps) * norm_ref[0]

            sy = ref["sy_ref"]

            @pl.when(prog == P.p_pre)
            def _pre():
                report(0, ref["y8_ref"][:, :P.h],
                       normed(ref["an_ref"]) / sy[:, :1])

            @pl.when(prog == P.p_rope)
            def _rope():
                qkv, D, qdim = ref["qkv_ref"], P.D, P.qdim
                kr = [kh * ref["cos_ref"][:] + jax.lax.dot_general(
                    kh, ref["prot_ref"][:], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32) * ref["sin_ref"][:]
                    for kh in (qkv[:, qdim + i * D:qdim + (i + 1) * D]
                               for i in range(P.KVH))]
                kr = jnp.stack(kr, axis=1)[:P.B]
                report(1, ref["k8_ref"][0], kr / ref["ks8_ref"][0][..., None])
                vh = qkv[:, 2 * qdim:3 * qdim].reshape(-1, P.KVH, D)[:P.B]
                report(2, ref["v8_ref"][0], vh / ref["vs8_ref"][0][..., None])

            @pl.when(prog == P.p_fin)
            def _fin():
                report(0, ref["y8_ref"][:, :P.qdim],
                       ref["qkv_ref"][:, 2 * P.qdim:3 * P.qdim] / sy[:, :1])

            @pl.when(prog == P.p_mlp)
            def _mlp():
                report(0, ref["y8_ref"][:, :P.h],
                       normed(ref["mn_ref"]) / sy[:, :1])

            @pl.when(prog == P.p_dq)
            def _dq():
                report(0, ref["m8_ref"][:],
                       ref["g_ref"][:].astype(jnp.float32) / sy[:, :1])
        return body

    def _mega_flush(self, orig):
        """The reference's megastep: after the kernel, its reports join the
        record in (layer, program) order, cut to the caller's rows."""
        def wrapped(x0, *args, **kw):
            out = orig(x0, *args, **kw)
            rows = x0.shape[0]

            def flush(_):
                self.jax.extend((c[:rows], r[:rows])
                                for _, c, r in sorted(
                                    self.pending, key=lambda e: e[0]))
                self.pending.clear()
            jax.debug.callback(flush, out, ordered=True)
            return out
        return wrapped

    def __enter__(self):
        super().__enter__()
        self.mega_saved = (JM._megastep_kernel, JM.megastep)
        JM._megastep_kernel = self._mega_body(JM._megastep_kernel)
        JM.megastep = self._mega_flush(JM.megastep)
        return self

    def __exit__(self, *exc):
        JM._megastep_kernel, JM.megastep = self.mega_saved
        return super().__exit__(*exc)


_KW_STATIC = ("num_bits", "rank", "eps", "kvhd")


def _jax_mega_fn(*args, num_bits, rank, eps, kvhd):
    """The reference's megastep as the module attribute looked up when
    traced (so that the recorder's wrappers take part)."""
    return JM.megastep(*args, num_bits=num_bits, rank=rank, eps=eps,
                       kvhd=kvhd, interpret=True)


_jax_mega = jax.jit(_jax_mega_fn, static_argnames=_KW_STATIC)


def _cache_arrays(seed, config, B, T):
    """A seeded int8 head-major cache, as numpy arrays (k, v, k_scale,
    v_scale)."""
    rng = np.random.default_rng(seed)
    shape = (config.num_layers, B, config.num_kv_heads, T, config.head_dim)
    return (rng.integers(-127, 128, size=shape, dtype=np.int8),
            rng.integers(-127, 128, size=shape, dtype=np.int8),
            rng.uniform(1e-3, 2e-2, shape[:4]).astype(np.float32),
            rng.uniform(1e-3, 2e-2, shape[:4]).astype(np.float32))


def _tcache(arrays):
    return TL.HeadMajorQuantKVCache(*(torch.from_numpy(a.copy())
                                      for a in arrays))


def _jcache(arrays):
    return JL.HeadMajorQuantKVCache(*(jnp.asarray(a) for a in arrays))


class TestSupport:
    def test_supported_matrix(self):
        # tiny-mha on "l" is taken; GQA (TINY), the "xla" layout and a batch
        # of 33 are refused, by both packages the same way
        config, jparams, tparams = _params("tiny-mha-l")
        cfg = _port_config(config)
        assert JP.persistent_supported(jparams, config)
        assert TP.persistent_supported(tparams, cfg)
        for name in ("tiny-l", "tiny-mha"):
            c, jp, tp = _params(name)
            assert not JP.persistent_supported(jp, c)
            assert not TP.persistent_supported(tp, _port_config(c))
        with pytest.raises(ValueError, match="not supported"):
            c, _, tp = _params("tiny-l")
            TP.decode_step_persistent(
                tp, torch.tensor([1, 2]), torch.tensor([0, 0],
                                                       dtype=torch.int32),
                TL.HeadMajorQuantKVCache.create(_port_config(c), 2, 16,
                                                device="cpu"),
                _port_config(c))
        arrays = _cache_arrays(0, config, 33, 16)
        args, kw = TP.megastep_operands(
            tparams, torch.zeros(33, dtype=torch.int64),
            torch.zeros(33, dtype=torch.int32), _tcache(arrays), cfg)
        with pytest.raises(ValueError, match="megastep constraints"):
            TM.megastep(*args, **kw)
        with pytest.raises(AssertionError, match="constraints"):
            JM.megastep(*(jnp.asarray(a.numpy()) for a in args), **kw,
                        interpret=True)
        # the predicate against the reference's plan over a grid of shapes
        for B, h, im, KVH, D, rank, bits in (
                (8, 4096, 11008, 32, 128, 128, 4), (32, 512, 1024, 4, 128,
                                                    128, 2),
                (33, 512, 1024, 4, 128, 128, 4), (8, 512, 1024, 4, 64, 128,
                                                  4),
                (8, 512, 1024, 4, 128, 64, 4), (8, 512, 1024, 4, 128, 128,
                                                8),
                (8, 512, 96, 4, 128, 128, 4), (8, 512, 1024 * 33, 4, 128,
                                               128, 4)):
            try:        # the plan asserts on more than 128 gate/up blocks
                ok = JM._Plan(h=h, im=im, qdim=KVH * D, kvdim=KVH * D,
                              KVH=KVH, D=D, rank=rank, num_bits=bits, B=B,
                              T=128).supported()
            except AssertionError:
                ok = False
            assert TM.megastep_supported(
                B, h, im, KVH, D, rank, bits, 3 * KVH * D) == ok
        assert not TM.megastep_supported(8, 512, 1024, 4, 128, 128, 4, 1024)

    def test_gateup_interleaving_matches_reference(self):
        config, jparams, tparams = _params("tiny-mha-l")
        im = config.intermediate_size
        assert TP.megastep_bng(im) == JP.megastep_bng(im)
        ref = JP.prepare_gateup_interleaved(jparams.layers.gateup, im)
        got = TP.prepare_gateup_interleaved(tparams.layers.gateup, im)
        for name in ref._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))


def _operands(tparams, cfg, tokens, pos, arrays):
    args, kw = TP.megastep_operands(
        tparams, torch.from_numpy(tokens.astype(np.int64)),
        torch.from_numpy(pos), _tcache(arrays), cfg)
    return args, kw


class TestMegastepPlain:
    @pytest.mark.parametrize("B,pos,T", [(2, (0, 9), 160), (8, (5,) * 8, 128)])
    def test_matches_reference(self, B, pos, T):
        # megastep_plain against the reference's interpret-mode megastep on
        # the same operands: ragged rows (one at 0: only the staged token)
        # over one 160-token block, and a full batch of 8; every int8
        # rounding replayed at its knife edge, then x_out at the factor
        # paths' bound and the staged K/V codes equal
        config, _, tparams = _params("tiny-mha-l")
        cfg = _port_config(config)
        rng = np.random.default_rng(40 + B)
        tokens = rng.integers(0, config.vocab_size, size=B)
        args, kw = _operands(tparams, cfg, tokens, np.asarray(pos, np.int32),
                             _cache_arrays(41 + B, config, B, T))
        jargs = [jnp.asarray(a.numpy()) for a in args]
        with _MegaRounding(_jax_mega, static=_KW_STATIC) as rec:
            ref, got, first, flips, worst = _replay(
                rec, lambda: rec.jax_step(*jargs, **kw),
                lambda: [t.numpy() for t in TM.megastep(*args, **kw)],
                max_flips=FACTOR_MAX_FLIPS, ratio_tol=MEGA_RATIO_TOL)
        ref = [np.asarray(r) for r in ref]
        print(f"\nmegastep B={B} pos {pos}: {flips} codes replayed (worst "
              f"{worst:.2e} of a code); x_out {_rel(first[0], ref[0]):.2e} "
              f"before, {_rel(got[0], ref[0]):.2e} after")
        assert _rel(got[0], ref[0]) <= FACTOR_LOGIT_REL
        for i in (1, 3):
            np.testing.assert_array_equal(got[i], ref[i])
        for i in (2, 4):
            np.testing.assert_allclose(got[i], ref[i], rtol=LOGIT_RTOL)


def _persistent_both(rec, params, tokens, pos, jcache, tcache, staged_kv):
    """One decode_step_persistent of the reference (interpret mode) and of
    the port from the same cache (``tcache`` is overwritten with
    ``jcache``), replayed at the roundings; logits held to the factor
    paths' bound with the same argmax, the committed caches compared.
    Returns the reference's logits and cache and the port's cache."""
    config, jparams, tparams = params
    pre = [np.array(a) for a in jcache]

    def run_jax():
        return rec.jax_step(jparams, jnp.asarray(tokens), jnp.asarray(pos),
                            jcache, config, interpret=True,
                            staged_kv=staged_kv)

    def run_port():
        _reset(tcache, pre)
        return TP.decode_step_persistent(
            tparams, torch.from_numpy(tokens.astype(np.int64)),
            torch.from_numpy(pos), tcache, _port_config(config),
            staged_kv=staged_kv)[0].numpy()

    (jl, jcache), tl, first, flips, _ = _replay(
        rec, run_jax, run_port, max_flips=FACTOR_MAX_FLIPS,
        ratio_tol=MEGA_RATIO_TOL)
    jl = np.asarray(jl)
    assert _rel(tl, jl) <= FACTOR_LOGIT_REL, _rel(tl, jl)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    _assert_caches_match(tcache, jcache, FACTOR_LOGIT_REL)
    print(f"\npersistent staged_kv={staged_kv!r} pos {pos.tolist()}: {flips} "
          f"codes replayed; logits {_rel(first, jl):.2e} before, "
          f"{_rel(tl, jl):.2e} after")
    return jl, jcache, tcache


class TestDecodeStepPersistent:
    def test_per_row_commit_matches_reference(self):
        # ragged rows, one at 0, committed per row ("on"); the port's
        # "uniform" mode gives the same cache (the reference's guard falls
        # back to the per-row commit for ragged positions)
        params = _params("tiny-mha-l")
        config = params[0]
        arrays = _cache_arrays(60, config, 3, 128)
        for b, p in enumerate((2, 0, 11)):      # tokens < pos only
            for a in arrays:
                a[:, b, :, p:] = 0
        tokens = np.asarray([3, 7, 11], np.int32)
        pos = np.asarray([2, 0, 11], np.int32)
        tcache = _tcache(arrays)
        with _MegaRounding(JP.decode_step_persistent,
                           static=("config", "interpret", "staged_kv")) as rec:
            _, _, tcache = _persistent_both(rec, params, tokens, pos,
                                            _jcache(arrays), tcache, "on")
        uniform = _tcache(arrays)
        TP.decode_step_persistent(params[2], torch.from_numpy(
            tokens.astype(np.int64)), torch.from_numpy(pos), uniform,
            _port_config(config), staged_kv="uniform")
        for name in ("k", "v"):
            assert torch.equal(getattr(uniform, name), getattr(tcache, name))
        for b, p in enumerate(pos):
            assert float(tcache.k_scale[0, b, :, p].min()) > 0

    def test_greedy_steps_match_reference(self):
        # three greedy steps from an empty cache with the default "uniform"
        # commit, each from the reference's cache: equal tokens
        params = _params("tiny-mha-l")
        config = params[0]
        B = 2
        jcache = JL.HeadMajorQuantKVCache.create(config, B, 128)
        tcache = TL.HeadMajorQuantKVCache.create(_port_config(config), B, 128,
                                                 device="cpu")
        tokens = np.asarray([11, 23], np.int32)
        with _MegaRounding(JP.decode_step_persistent,
                           static=("config", "interpret", "staged_kv")) as rec:
            for step in range(3):
                pos = np.full(B, step, np.int32)
                jl, jcache, tcache = _persistent_both(
                    rec, params, tokens, pos, jcache, tcache, "uniform")
                tokens = jl.argmax(-1).astype(np.int32)

    @pytest.mark.parametrize("B,posvals", [(2, (6, 6)), (2, (0, 9)),
                                           (8, (5,) * 8)])
    def test_matches_fused_l_step(self, B, posvals):
        # the reference's own check (tests/test_megastep.py), on the port
        # alone: the megastep step against the fused "l" step (staged,
        # f32 dots) from one cache. They differ on purpose in the bf16
        # staging of m before its int8 codes, so logits agree to quantization
        # noise (rel < 5e-2, argmax equal, every row at B 8); layer 0 sees
        # the same inputs in both, so its codes are identical; later layers'
        # codes may differ at rounding edges (< 1%).
        config, _, tparams = _params("tiny-mha-l")
        cfg = _port_config(config)
        arrays = _cache_arrays(80 + B, config, B, 128)
        tokens = torch.arange(1, B + 1) * 3
        pos = torch.tensor(posvals, dtype=torch.int32)
        ca, cb = _tcache(arrays), _tcache(arrays)
        la, ca = TF.decode_step_fused(tparams, tokens, pos, ca, cfg,
                                      staged_kv=True, attn_dots="f32")
        lb, cb = TP.decode_step_persistent(tparams, tokens, pos, cb, cfg,
                                           staged_kv="on")
        la, lb = la.numpy(), lb.numpy()
        per_row = (np.linalg.norm(lb - la, axis=-1)
                   / np.linalg.norm(la, axis=-1))
        assert (per_row < 5e-2).all(), per_row
        np.testing.assert_array_equal(la.argmax(-1), lb.argmax(-1))
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(ca, name)[0], getattr(cb, name)[0])
        assert float((ca.k != cb.k).float().mean()) < 0.01


@pytest.mark.parametrize("name,bits,ctas", [
    (name, bits, ctas) for name in ("llama2-7b", "tiny-mha")
    for bits in (2, 4) for ctas in (132, 7, 1)])
def test_megastep_split_plan_covers_once(name, bits, ctas):
    # the projection stages' plan (csrc/megastep_proj.cuh, mirrored by
    # ops/megastep.py): the warps' slab ranges partition each stage, every
    # (weight row, 128-byte chunk) is one slab's exactly once (the gate/up
    # groups through the interleaved blocks), a group's contributors (the
    # warps whose nonempty ranges meet it: a stage of fewer slabs than
    # warps leaves some empty) are the owners _contributors walks, each
    # warp's split groups take distinct partial slots, and the counters
    # cover every stage's groups
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        LLAMA2_7B, TINY_MHA)
    cfg = {"llama2-7b": LLAMA2_7B, "tiny-mha": TINY_MHA}[name]
    h, im, qdim = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim
    bng = TM._bn(256, im)
    W = ctas * TM._WARPS
    stages = TM._stage_plan(h, im, qdim, bits, bng)
    assert TM._counters(h, im, qdim) >= max(s[2] for s in stages)
    for P, nk, groups, nrows, b in stages:
        assert (nk - 1) * TM._KC < P <= nk * TM._KC
        S = groups * nk
        ranges = [TM._warp_range(S, w, W) for w in range(W)]
        assert ranges[0][0] == 0 and ranges[-1][1] == S
        assert all(ranges[w][1] == ranges[w + 1][0] for w in range(W - 1))
        hits = np.zeros((nrows, nk), np.int32)
        slots = {}
        for w, (lo, hi) in enumerate(ranges):
            for s in range(lo, hi):
                g, c = divmod(s, nk)
                for r in TM._group_rows(g, b):
                    hits[r:r + TM._TILE_ROWS, c] += 1
            for g in range(lo // nk, -(-hi // nk)) if lo < hi else ():
                if lo <= g * nk and hi >= (g + 1) * nk:
                    continue           # the whole group: no partial
                slot = 0 if g == lo // nk else 1
                assert slot == 0 or g == (hi - 1) // nk
                assert (w, slot) not in slots
                slots[w, slot] = g
        assert (hits == 1).all()
        for g in range(groups):
            touch = [w for w, (lo, hi) in enumerate(ranges)
                     if lo < hi and lo < (g + 1) * nk and hi > g * nk]
            assert TM._contributors(g, nk, S, W) == touch
            if len(touch) > 1:
                assert sorted(w for (w, _), gg in slots.items()
                              if gg == g) == touch
