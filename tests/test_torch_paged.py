"""PyTorch port, paged serving: ``ops/attention.py::flash_decode_q8_paged``,
``serve/paged.py`` (fused W4A8 and unfused bf16 steps) and
``serve/paged_engine.py`` against the JAX reference on the CPU (Pallas
kernels in interpret mode, or the reference's XLA twins on the unfused
path).

Pools, tables and prompts are made with numpy from seeds and handed to both
packages. Steps and whole engine runs that round to int8 go through the
rounding replay of ``tests/test_torch_fused.py`` before the tight bound."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.ops import attention as JA
from ee274_convexcaldera_llm_quantization_tpu.serve import engine as JE
from ee274_convexcaldera_llm_quantization_tpu.serve import paged as JP
from ee274_convexcaldera_llm_quantization_tpu.serve import (
    paged_engine as JPE)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused as TF
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as TA
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import engine as TE
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import paged as TP
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
    paged_engine as TPE)

from test_torch_fused import (  # noqa: F401 (a fixture)
    LOGIT_ATOL, LOGIT_RTOL, _Rounding, _assert_caches_match,
    _one_torch_thread, _params, _port_config, _replay, _torch_array)
from test_torch_model import GROUPED_ATOL, GROUPED_REL, _model

# the reference suite's paged-kernel bound (tests/test_paged_fused.py)
PAGED_REL = 3e-5
# the JAX suite's own kernel-vs-twin bound (tests/test_flash_attention.py)
RTOL, ATOL = 2e-5, 2e-6
# a whole engine run may replay more codes than one call
# (tests/test_torch_serve.py)
ENGINE_MAX_FLIPS = 64

_FUSED_DECODE = ("config", "interpret", "scratch_page", "tp_axis",
                 "attn_dots")
_FUSED_PREFILL = ("config", "interpret", "flash", "tp_axis")
_UNFUSED = ("config", "use_pallas", "interpret")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# The kernel's function
# ---------------------------------------------------------------------------

def _kernel_inputs(seed, L=2, NP=10, KVH=2, P=32, D=128, B=3, G=2,
                   max_pages=3, pos=(0, 17, 95), stacked_new=False):
    """The reference test's shapes (tests/test_paged_fused.py): a pool of
    random codes and scales, a randomly permuted page table."""
    rng = np.random.default_rng(seed)
    new_shape = (L, B, KVH, D) if stacked_new else (B, KVH, D)
    return dict(
        q=rng.standard_normal((B, KVH, G, D)).astype(np.float32),
        k=rng.integers(-127, 128, (L, NP, KVH, P, D)).astype(np.int8),
        v=rng.integers(-127, 128, (L, NP, KVH, P, D)).astype(np.int8),
        ks=rng.uniform(0.005, 0.02, (L, NP, KVH, P)).astype(np.float32),
        vs=rng.uniform(0.005, 0.02, (L, NP, KVH, P)).astype(np.float32),
        k_new=rng.standard_normal(new_shape).astype(np.float32),
        v_new=rng.standard_normal(new_shape).astype(np.float32),
        pt=rng.permutation(NP)[:B * max_pages].reshape(B, max_pages)
        .astype(np.int32),
        pos=np.asarray(pos, np.int32))


_ARGS = ("q", "k", "v", "ks", "vs", "k_new", "v_new")


def _port_paged(inp, layer, fn=TA.flash_decode_q8_paged, **kw):
    t = [_t(inp[n]) for n in _ARGS]
    return fn(*t, layer, _t(inp["pt"]), _t(inp["pos"]), **kw).numpy()


def _jax_paged(inp, layer, fn=JA.flash_decode_q8_paged, **kw):
    j = [jnp.asarray(inp[n]) for n in _ARGS]
    return np.asarray(fn(*j, jnp.asarray(layer, jnp.int32),
                         jnp.asarray(inp["pt"]), jnp.asarray(inp["pos"]),
                         **kw))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class TestPagedFlashDecode:
    @pytest.mark.parametrize("dots", ["f32", "i8"])
    @pytest.mark.parametrize("seed,pos,stacked_new", [
        (0, (0, 17, 95), False),          # the reference test's rows
        (1, (32, 64, 33), True)])         # page edges, layer-stacked k_new
    def test_matches_pallas_interpret(self, dots, seed, pos, stacked_new):
        inp = _kernel_inputs(seed, pos=pos, stacked_new=stacked_new)
        out = _port_paged(inp, 1, dots=dots)
        ref = _jax_paged(inp, 1, interpret=True, dots=dots)
        assert _rel(out, ref) < PAGED_REL
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)

    def test_f32_matches_xla_twin(self):
        inp = _kernel_inputs(2, pos=(5, 0, 90))
        ref = _jax_paged(inp, 0, fn=JA.flash_decode_q8_paged_xla)
        for fn in (TA.flash_decode_q8_paged, TA.flash_decode_q8_paged_xla):
            out = _port_paged(inp, 0, fn=fn)
            assert _rel(out, ref) < PAGED_REL, fn.__name__
            np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("dots", ["f32", "i8"])
    def test_identity_tables_equal_the_staged_kernel(self, dots):
        # page == block and identity tables: the same blocks in the same
        # order as the staged kernel's walk, so the same bits
        B, KVH, P, n = 3, 2, 32, 3
        inp = _kernel_inputs(3, NP=B * n, B=B, P=P, max_pages=n,
                             pos=(0, 40, 96))
        inp["pt"] = np.arange(B * n, dtype=np.int32).reshape(B, n)
        paged = _port_paged(inp, 1, dots=dots)

        def contiguous(a):   # (L, B*n, KVH, P, ...) -> (L, B, KVH, n*P, ...)
            a = a.reshape(a.shape[0], B, n, KVH, P, *a.shape[4:])
            a = np.swapaxes(a, 2, 3)
            return a.reshape(a.shape[0], B, KVH, n * P, *a.shape[5:])
        t = [_t(inp[n_]) for n_ in ("q",)] + [
            _t(contiguous(inp[n_])) for n_ in ("k", "v", "ks", "vs")] + [
            _t(inp["k_new"]), _t(inp["v_new"])]
        staged = TA.flash_decode_q8_staged(*t, 1, _t(inp["pos"]),
                                           block_t=P, dots=dots).numpy()
        np.testing.assert_array_equal(paged, staged)

    def test_page_table_rules(self):
        inp = _kernel_inputs(4)
        for bad, err in ((10, IndexError), (-1, IndexError)):
            inp2 = dict(inp, pt=inp["pt"].copy())
            inp2["pt"][1, 2] = bad
            with pytest.raises(err, match="out of range"):
                _port_paged(inp2, 0)
        with pytest.raises(ValueError, match="integer"):
            _port_paged(dict(inp, pt=inp["pt"].astype(np.float32)), 0)
        # dots="bf16" raised until it was ported; it is the reference's now
        np.testing.assert_allclose(
            _port_paged(inp, 0, dots="bf16"),
            _jax_paged(inp, 0, interpret=True, dots="bf16"), rtol=RTOL,
            atol=ATOL)
        with pytest.raises(ValueError, match="unknown dots"):
            _port_paged(inp, 0, dots="bf8")
        with pytest.raises(IndexError, match="layer"):
            _port_paged(inp, 2)


# ---------------------------------------------------------------------------
# The fused W4A8 steps
# ---------------------------------------------------------------------------

P_FUSED, NP_FUSED, MAX_PAGES = 8, 12, 4


def _pool_arrays(pool):
    return [np.array(a) for a in pool]


def _port_pool(cls, arrays):
    return cls(*[_torch_array(a).clone() for a in arrays])


def _reset(tpool, arrays):
    for f, a in zip(dataclasses.fields(tpool), arrays):
        getattr(tpool, f.name).copy_(_torch_array(a))


@pytest.fixture(scope="module")
def fused_state():
    """Tiny fused params and a pool holding two prompts (11 and 19 tokens)
    prefilled by the reference through permuted page tables; the last page
    is the scratch page."""
    config, jparams, tparams = _params("tiny")
    rng = np.random.default_rng(20)
    perm = rng.permutation(NP_FUSED - 1)
    tables = np.zeros((3, MAX_PAGES), np.int32)
    tables[0, :2] = perm[:2]
    tables[1, :3] = perm[2:5]
    tables[2, :] = perm[5]       # inactive row: a page that holds tokens
    pool = JP.PagedQuantKVPool.create(config, NP_FUSED, P_FUSED)
    lens = (11, 19)
    for b, S in enumerate(lens):
        prompt = rng.integers(0, config.vocab_size, (1, S)).astype(np.int32)
        _, pool = JP.paged_prefill_fused(
            jparams, jnp.asarray(prompt), pool, jnp.asarray(tables[b]),
            config, interpret=True)
    return dict(params=(config, jparams, tparams), pool=_pool_arrays(pool),
                tables=tables, lens=lens)


class TestPagedFusedStep:
    @pytest.mark.parametrize("dots", ["f32", "i8"])
    def test_decode_matches_reference(self, fused_state, dots):
        # three ticks of rows at ragged positions (one crosses a page edge),
        # the third row inactive, each tick from the reference's pool
        config, jparams, tparams = fused_state["params"]
        tables = fused_state["tables"]
        arrays = fused_state["pool"]
        active = np.asarray([True, True, False])
        rng = np.random.default_rng(21)
        tpool = _port_pool(TP.PagedQuantKVPool, arrays)
        readings = []
        with _Rounding(JP.paged_decode_step_fused, _FUSED_DECODE) as rec:
            for step in range(3):
                pos = np.asarray([fused_state["lens"][0] + step,
                                  fused_state["lens"][1] + step, 0], np.int32)
                toks = rng.integers(0, config.vocab_size, 3).astype(np.int32)
                pre = list(arrays)

                def run_jax():
                    return rec.jax_step(
                        jparams, jnp.asarray(toks), jnp.asarray(pos),
                        JP.PagedQuantKVPool(*map(jnp.asarray, pre)),
                        jnp.asarray(tables), config, interpret=True,
                        active=jnp.asarray(active),
                        scratch_page=NP_FUSED - 1, attn_dots=dots)

                def run_port():
                    _reset(tpool, pre)
                    return TP.paged_decode_step_fused(
                        tparams, _i64(toks), _t(pos), tpool, _t(tables),
                        _port_config(config), active=_t(active),
                        scratch_page=NP_FUSED - 1, attn_dots=dots)[0].numpy()

                (jl, jpool), tl, _, flips, _ = _replay(rec, run_jax,
                                                       run_port)
                jl = np.asarray(jl)
                np.testing.assert_allclose(tl, jl, rtol=LOGIT_RTOL,
                                           atol=LOGIT_ATOL)
                _assert_caches_match(tpool, jpool)
                arrays = _pool_arrays(jpool)
                readings.append(flips)
        # the inactive row's page (and every page but the live ones and the
        # scratch page) kept its tokens
        live = set(tables[0, :3]) | set(tables[1, :4]) | {NP_FUSED - 1}
        for p in set(range(NP_FUSED)) - live:
            np.testing.assert_array_equal(arrays[0][:, p],
                                          fused_state["pool"][0][:, p])
        print(f"\npaged fused decode dots={dots}: codes replayed per tick "
              f"{readings}")

    @pytest.mark.parametrize("case", ["cold", "cold-flash", "suffix"])
    def test_prefill_matches_reference(self, fused_state, case):
        # a 19-token prompt over three permuted pages; the suffix case
        # prefills the last 3 tokens over two pages a 16-token prefix wrote
        config, jparams, tparams = fused_state["params"]
        rng = np.random.default_rng(22)
        prompt = rng.integers(0, config.vocab_size, (1, 19)).astype(np.int32)
        table = np.zeros(MAX_PAGES, np.int32)
        table[:3] = rng.permutation(NP_FUSED)[:3]
        pool = JP.PagedQuantKVPool.create(config, NP_FUSED, P_FUSED)
        if case == "suffix":
            _, pool = JP.paged_prefill_fused(
                jparams, jnp.asarray(prompt[:, :16]), pool,
                jnp.asarray(table), config, interpret=True)
        pre = _pool_arrays(pool)
        tpool = _port_pool(TP.PagedQuantKVPool, pre)
        cfg = _port_config(config)
        if case == "suffix":
            fn, static = JP.paged_prefill_suffix_fused, ("config",
                                                          "interpret")
            jargs = (jnp.asarray(prompt[:, 16:]), jnp.asarray(16, jnp.int32))
            jkw = {}

            def port():
                return TP.paged_prefill_suffix_fused(
                    tparams, _i64(prompt[:, 16:]), 16, tpool, _t(table), cfg)
        else:
            flash = case == "cold-flash"
            fn, static = JP.paged_prefill_fused, _FUSED_PREFILL
            jargs, jkw = (jnp.asarray(prompt),), dict(flash=flash)

            def port():
                return TP.paged_prefill_fused(tparams, _i64(prompt), tpool,
                                              _t(table), cfg, flash=flash)

        with _Rounding(fn, static) as rec:
            def run_jax():
                return rec.jax_step(
                    jparams, *jargs, JP.PagedQuantKVPool(*map(jnp.asarray,
                                                              pre)),
                    jnp.asarray(table), config, interpret=True, **jkw)

            def run_port():
                _reset(tpool, pre)
                return port()[0].numpy()

            (jl, jpool), tl, _, flips, _ = _replay(rec, run_jax, run_port)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)
        _assert_caches_match(tpool, jpool, scale_rtol=5e-4)
        print(f"\npaged fused prefill {case}: {flips} codes replayed")

    def test_prefill_write_layout(self):
        # pool[l][pages, :, offs] with the advanced indices on dims 0 and 2:
        # the broadcast dimension goes first, (S, KVH, D), in torch as in
        # the reference's ck.at[l, tok_pages, :, tok_offs]
        cfg = _port_config(_params("tiny")[0])
        pool = TP.PagedQuantKVPool.create(cfg, 4, 4, device="cpu")
        S = 7
        rng = np.random.default_rng(23)
        k = torch.from_numpy(rng.standard_normal(
            (1, S, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32))
        pages, offs = TP._token_pages(torch.tensor([2, 0, 3, 1]),
                                      torch.arange(S), 4)
        TP._write_pages(pool, 1, pages, offs, k, k)
        kq, ksc = TL.quantize_kv(k)
        for i in range(S):
            p, o = [2, 0][i // 4], i % 4
            assert torch.equal(pool.k[1, p, :, o], kq[0, i])
            assert torch.equal(pool.k_scale[1, p, :, o], ksc[0, i])
        assert int(pool.k[0].abs().sum()) == 0

    @pytest.mark.parametrize("dots", ["f32", "i8"])
    def test_paged_step_equals_staged_step(self, dots):
        # identity tables, page_size == the staged kernel's block (256):
        # the same kernels over the same blocks, so equal logits and equal
        # pool / cache codes, bit for bit
        _, _, tparams = _params("tiny")
        cfg = _port_config(_params("tiny")[0])
        B, P, n = 2, 256, 2
        rng = np.random.default_rng(24)
        cache = TL.HeadMajorQuantKVCache.create(cfg, B, n * P, device="cpu")
        pool = TP.PagedQuantKVPool.create(cfg, B * n, P, device="cpu")
        tables = torch.arange(B * n, dtype=torch.int32).reshape(B, n)
        lens = (300, 7)
        for b, S in enumerate(lens):
            prompt = _i64(rng.integers(0, cfg.vocab_size, (1, S)))
            lc, _ = TF.prefill_into_slot_fused(tparams, prompt, b, cache, cfg,
                                               flash=True)
            lp, _ = TP.paged_prefill_fused(tparams, prompt, pool, tables[b],
                                           cfg, flash=True)
            assert torch.equal(lc, lp)
        for step in range(2):
            toks = _i64(rng.integers(0, cfg.vocab_size, B))
            pos = torch.tensor([lens[0] + step, lens[1] + step],
                               dtype=torch.int32)
            lc, _ = TF.decode_step_fused(tparams, toks, pos, cache, cfg,
                                         staged_kv=True, attn_dots=dots)
            lp, _ = TP.paged_decode_step_fused(tparams, toks, pos, pool,
                                               tables, cfg, attn_dots=dots)
            assert torch.equal(lc, lp)
        for name in ("k", "v", "k_scale", "v_scale"):
            c = getattr(cache, name)                  # (L, B, KVH, n*P, ...)
            p = getattr(pool, name).reshape(c.shape[0], B, n, *c.shape[2:3],
                                            P, *c.shape[4:])
            p = p.transpose(2, 3).reshape(c.shape)
            assert torch.equal(c, p), name

    def test_inactive_rows_write_scratch_only(self):
        _, _, tparams = _params("tiny")
        cfg = _port_config(_params("tiny")[0])
        pool = TP.PagedQuantKVPool.create(cfg, 5, 16, device="cpu")
        g = torch.Generator().manual_seed(3)
        live = torch.randint(-127, 128, pool.k[:, :4].shape, generator=g,
                             dtype=torch.int8)
        pool.k[:, :4] = live
        pool.v[:, :4] = live
        before = dataclasses.replace(pool, k=pool.k.clone(),
                                     v=pool.v.clone())
        tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
        TP.paged_decode_step_fused(
            tparams, torch.tensor([1, 2]),
            torch.tensor([3, 0], dtype=torch.int32), pool, tables, cfg,
            active=torch.tensor([True, False]), scratch_page=4)
        # row 1 inactive: its pages 2, 3 are untouched, its write went to
        # the scratch page 4 at offset 0; row 0 wrote page 0 at offset 3
        assert torch.equal(pool.k[:, 2:4], before.k[:, 2:4])
        assert torch.equal(pool.v[:, 1:4], before.v[:, 1:4])
        assert pool.k_scale[:, 4, :, 0].min() > 0
        assert not torch.equal(pool.k[:, 0, :, 3], before.k[:, 0, :, 3])
        assert torch.equal(pool.k[:, 0, :, :3], before.k[:, 0, :, :3])

    def test_step_rules(self):
        _, _, tparams = _params("tiny")
        cfg = _port_config(_params("tiny")[0])
        pool = TP.PagedQuantKVPool.create(cfg, 4, 16, device="cpu")
        args = (tparams, torch.tensor([1]), torch.tensor([0],
                                                         dtype=torch.int32),
                pool, torch.tensor([[0, 1]], dtype=torch.int32), cfg)
        with pytest.raises(ValueError, match="scratch_page"):
            TP.paged_decode_step_fused(*args, active=torch.tensor([True]))
        # tp_axis (a process group; tests/test_torch_parallel.py) refuses a
        # row-parallel bias before any collective, as the reference does
        lp = tparams.layers
        biased = dataclasses.replace(tparams, layers=dataclasses.replace(
            lp, o_proj=dataclasses.replace(
                lp.o_proj, b=torch.zeros(lp.o_proj.packed.shape[:2]))))
        with pytest.raises(ValueError, match="bias"):
            TP.paged_decode_step_fused(biased, *args[1:], tp_axis="tp")
        with pytest.raises(ValueError, match="bias"):
            TP.paged_prefill_fused(biased, torch.tensor([[1, 2]]), pool,
                                   torch.tensor([0, 1]), cfg, tp_axis="tp")
        # attn_dots="bf16" raised until it was ported; an unknown mode raises
        with pytest.raises(ValueError, match="unknown dots"):
            TP.paged_decode_step_fused(*args, attn_dots="bf8")
        logits, _ = TP.paged_decode_step_fused(*args, attn_dots="bf16")
        assert bool(torch.isfinite(logits).all())
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                TP.PagedQuantKVPool.create(cfg, 4, 16)


# ---------------------------------------------------------------------------
# The unfused bf16 steps
# ---------------------------------------------------------------------------

P_PLAIN, NP_PLAIN = 4, 16


def _unfused_close(mode, got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    if mode == "grouped":
        assert _rel(got, ref) <= GROUPED_REL
        np.testing.assert_allclose(got, ref, rtol=0, atol=GROUPED_ATOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)


def _run_both(mode, fn, static, run_jax_with, run_port):
    """(reference output, port output, codes replayed): the w4a8 path under
    the rounding replay, the grouped path (bf16 roundings only) once."""
    if mode == "grouped":
        return run_jax_with(fn), run_port(), 0
    with _Rounding(fn, static) as rec:
        jout, tout, _, flips, _ = _replay(
            rec, lambda: run_jax_with(rec.jax_step), run_port)
    return jout, tout, flips


class TestPagedUnfusedSteps:
    @pytest.mark.parametrize("mode", ["grouped", "w4a8"])
    def test_decode_matches_reference(self, mode):
        # rows at ragged positions over permuted pages; the third row is
        # inactive and its table points at the first row's live page
        config, jp, tp = _model("tiny", mode)
        cfg = _port_config(config)
        rng = np.random.default_rng(30)
        perm = rng.permutation(NP_PLAIN)
        tables = np.zeros((3, 4), np.int32)
        tables[0, :3], tables[1, :2] = perm[:3], perm[3:5]
        tables[2, :] = perm[0]
        pool = JP.PagedKVPool.create(config, NP_PLAIN, P_PLAIN)
        for b, S in enumerate((9, 6)):
            prompt = rng.integers(0, config.vocab_size, (1, S)).astype(
                np.int32)
            _, pool = JP.paged_prefill(jp, jnp.asarray(prompt), pool,
                                       jnp.asarray(tables[b]), config)
        pre = _pool_arrays(pool)
        tpool = _port_pool(TP.PagedKVPool, pre)
        toks = rng.integers(0, config.vocab_size, 3).astype(np.int32)
        pos = np.asarray([9, 6, 0], np.int32)
        active = np.asarray([True, True, False])

        def run_jax_with(step):
            return step(jp, jnp.asarray(toks), jnp.asarray(pos),
                        JP.PagedKVPool(*map(jnp.asarray, pre)),
                        jnp.asarray(tables), config, use_pallas=False,
                        active=jnp.asarray(active))

        def run_port():
            _reset(tpool, pre)
            return TP.paged_decode_step(
                tp, _i64(toks), _t(pos), tpool, _t(tables), cfg,
                active=_t(active))[0].numpy()

        (jl, jpool), tl, flips = _run_both(mode, JP.paged_decode_step,
                                           _UNFUSED, run_jax_with, run_port)
        _unfused_close(mode, tl, jl)
        _assert_caches_match(tpool, jpool)
        # the inactive row wrote nothing: row 0's page holds its tokens
        np.testing.assert_array_equal(
            tpool.k[:, perm[0]].float().numpy(),
            np.asarray(pre[0][:, perm[0]].astype(np.float32)))
        print(f"\npaged unfused decode {mode}: {flips} codes replayed")

    @pytest.mark.parametrize("case", ["cold", "suffix"])
    @pytest.mark.parametrize("mode", ["grouped", "w4a8"])
    def test_prefill_matches_reference(self, mode, case):
        config, jp, tp = _model("tiny", mode)
        cfg = _port_config(config)
        rng = np.random.default_rng(31)
        prompt = rng.integers(0, config.vocab_size, (1, 11)).astype(np.int32)
        table = np.zeros(4, np.int32)
        table[:3] = rng.permutation(NP_PLAIN)[:3]
        pool = JP.PagedKVPool.create(config, NP_PLAIN, P_PLAIN)
        if case == "suffix":
            _, pool = JP.paged_prefill(jp, jnp.asarray(prompt[:, :8]), pool,
                                       jnp.asarray(table), config)
        pre = _pool_arrays(pool)
        tpool = _port_pool(TP.PagedKVPool, pre)
        if case == "suffix":
            fn = JP.paged_prefill_suffix

            def run_jax_with(step):
                return step(jp, jnp.asarray(prompt[:, 8:]),
                            jnp.asarray(8, jnp.int32),
                            JP.PagedKVPool(*map(jnp.asarray, pre)),
                            jnp.asarray(table), config, use_pallas=False)

            def port():
                return TP.paged_prefill_suffix(tp, _i64(prompt[:, 8:]), 8,
                                               tpool, _t(table), cfg)
        else:
            fn = JP.paged_prefill

            def run_jax_with(step):
                return step(jp, jnp.asarray(prompt),
                            JP.PagedKVPool(*map(jnp.asarray, pre)),
                            jnp.asarray(table), config, use_pallas=False)

            def port():
                return TP.paged_prefill(tp, _i64(prompt), tpool, _t(table),
                                        cfg)

        def run_port():
            _reset(tpool, pre)
            return port()[0].numpy()

        (jl, jpool), tl, flips = _run_both(mode, fn, _UNFUSED, run_jax_with,
                                           run_port)
        _unfused_close(mode, tl, jl)
        _assert_caches_match(tpool, jpool)
        print(f"\npaged unfused prefill {mode} {case}: {flips} codes "
              "replayed")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _serve(engine, reqs, request_cls):
    for r in reqs:
        engine.submit(request_cls(**r))
    done = engine.run()
    return sorted((c.uid, list(map(int, c.tokens)), c.finished_reason)
                  for c in done)


def _prefix_requests(seed, vocab, shared, n=3, new_tokens=4):
    """``n`` greedy requests: a shared ``shared``-token prefix, then 3 to 6
    tokens of their own."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, shared)
    return [dict(uid=uid, prompt=np.concatenate(
        [prefix, rng.integers(0, vocab, int(rng.integers(3, 7)))]).astype(
            np.int32), max_new_tokens=new_tokens) for uid in range(n)]


class TestPagedServingEngine:
    @pytest.mark.parametrize("prefix_cache", [False, True])
    @pytest.mark.parametrize("kind", ["fused", "grouped"])
    def test_completions_match_reference(self, kind, prefix_cache):
        # three requests sharing a page-aligned prefix over two slots (one
        # waits for a slot); with the prefix cache the second and third
        # prefill only their suffixes over the shared pages. Plain params:
        # the grouped model (the w4a8 unfused steps are held to the
        # reference above)
        if kind == "fused":
            config, jparams, tparams = _params("tiny")
            page, shared = 8, 16
            jkw = dict(use_pallas=True, interpret=True)
            tkw = dict(flash_attn=True)
        else:
            config, jparams, tparams = _model("tiny", kind)
            page, shared = 4, 8
            jkw, tkw = dict(use_pallas=False), {}
        reqs = _prefix_requests(40 + len(kind) + prefix_cache,
                                config.vocab_size, shared)
        kw = dict(max_slots=2, num_pages=16, page_size=page,
                  prefix_cache=prefix_cache)
        engines = {}

        def run_jax():
            engines["jax"] = JPE.PagedServingEngine(jparams, config, **kw,
                                                    **jkw)
            return _serve(engines["jax"], reqs, JE.Request)

        def run_port():
            engines["port"] = TPE.PagedServingEngine(
                tparams, _port_config(config), device="cpu", **kw, **tkw)
            return _serve(engines["port"], reqs, TE.Request)

        if kind == "grouped":
            ref, got, flips = run_jax(), run_port(), 0
        else:
            with _Rounding() as rec:
                ref, got, _, flips, _ = _replay(rec, run_jax, run_port,
                                                ENGINE_MAX_FLIPS)
        assert len(ref) == len(reqs) and got == ref
        hits = [e.allocator.cache_stats[0] for e in engines.values()]
        assert hits[0] == hits[1] == (2 * shared if prefix_cache else 0)
        print(f"\npaged engine {kind} prefix_cache={prefix_cache}: {flips} "
              "codes replayed")

    def test_pool_pressure_reuses_pages(self, monkeypatch):
        # a pool too small for every request at once: admission waits for
        # pages, finished sequences' pages go to later ones in another
        # order, and the greedy completions equal a roomy pool's
        _, _, tparams = _params("tiny")
        cfg = _port_config(_params("tiny")[0])
        rng = np.random.default_rng(41)
        reqs = [dict(uid=u, prompt=rng.integers(0, cfg.vocab_size, int(n))
                     .astype(np.int32), max_new_tokens=int(m))
                for u, (n, m) in enumerate(zip(rng.integers(5, 20, 6),
                                               rng.integers(3, 10, 6)))]
        tables = []
        step = TP.paged_decode_step_fused

        def spy(params, tokens, pos, pool, page_tables, *a, **kw):
            tables.append(page_tables.clone())
            return step(params, tokens, pos, pool, page_tables, *a, **kw)

        monkeypatch.setattr(TP, "paged_decode_step_fused", spy)
        out, waits = {}, {}
        # 8 pages: the native scheduler's admission check counts one free
        # decode page per request without holding it, so some smaller pools
        # run dry in the middle of a tick on this trace (ROADMAP R8)
        for pages in (64, 8):
            eng = TPE.PagedServingEngine(tparams, cfg, max_slots=3,
                                         num_pages=pages, page_size=4,
                                         flash_attn=True, device="cpu")
            for r in reqs:
                eng.submit(TE.Request(**r))
            waits[pages] = 0
            while eng.busy():
                eng.step()
                # a slot is free and a request queued after the tick: it
                # waits for pages, or for the next tick's admission
                waits[pages] += bool(eng.sched.queue_len
                                     and eng.sched.active_count < 3)
            out[pages] = sorted((c.uid, c.tokens) for c in eng.completions)
            assert eng.allocator.free_pages == pages
            assert eng.tokens_generated == sum(r["max_new_tokens"]
                                               for r in reqs)
        assert out[8] == out[64] and len(out[8]) == len(reqs)
        assert waits[8] > waits[64]
        # one page fewer and the live sequences take the page the last
        # admission counted on: the reference's scheduler raises mid-tick
        eng = TPE.PagedServingEngine(tparams, cfg, max_slots=3, num_pages=7,
                                     page_size=4, flash_attn=True,
                                     device="cpu")
        with pytest.raises(MemoryError, match="exhausted"):
            _serve(eng, reqs, TE.Request)
        # some table row is not ascending: pages came back out of order
        assert any(bool((row[1:] < row[:-1]).any()) and int(row[1]) > 0
                   for t in tables for row in t)

    def test_decode_tick_is_the_paged_step(self):
        # the engine's tick equals a direct paged_decode_step_fused call on
        # the same pool bit for bit
        _, _, tparams = _params("tiny")
        cfg = _port_config(_params("tiny")[0])
        rng = np.random.default_rng(42)
        eng = TPE.PagedServingEngine(tparams, cfg, max_slots=3, num_pages=8,
                                     page_size=8, device="cpu")
        for uid in range(2):
            eng.submit(TE.Request(uid=uid, prompt=rng.integers(
                0, cfg.vocab_size, 6 + 5 * uid), max_new_tokens=4))
        for uid, slot in eng.sched.admit():
            eng._admit(uid, slot)
        snap = dataclasses.replace(eng.pool, **{
            f.name: getattr(eng.pool, f.name).clone()
            for f in dataclasses.fields(eng.pool)})
        B = eng.max_slots
        tokens = torch.zeros(B, dtype=torch.int64)
        pos = torch.zeros(B, dtype=torch.int32)
        active = torch.zeros(B, dtype=torch.bool)
        for uid, s in eng._slot_of.items():
            tokens[s] = eng._last_tok[uid]
            pos[s] = eng.allocator.length(uid)
            active[s] = True
        eng._decode()
        tables = torch.zeros((B, eng.max_pages), dtype=torch.int32)
        for uid, s in eng._slot_of.items():
            pt = eng.allocator.page_table(uid, eng.max_pages)
            tables[s, :len(pt)] = torch.from_numpy(pt)
        logits, snap = TP.paged_decode_step_fused(
            tparams, tokens, pos, snap, tables, cfg, active=active,
            scratch_page=eng.scratch_page)
        assert {uid: eng._generated[uid][-1] for uid in eng._slot_of} == {
            uid: int(logits[s].argmax()) for uid, s in eng._slot_of.items()}
        for f in dataclasses.fields(snap):
            assert torch.equal(getattr(eng.pool, f.name),
                               getattr(snap, f.name)), f.name

    def test_more_requests_than_slots_and_priorities(self):
        config, _, tp = _model("tiny", "grouped")
        cfg = _port_config(config)
        rng = np.random.default_rng(43)
        eng = TPE.PagedServingEngine(tp, cfg, max_slots=1, num_pages=12,
                                     page_size=4, max_pages_per_seq=4,
                                     device="cpu")
        for uid, pri in [(0, 0), (1, 3), (2, 1), (3, 0), (4, 2)]:
            eng.submit(TE.Request(uid=uid, prompt=rng.integers(
                0, cfg.vocab_size, 4), max_new_tokens=3, priority=pri))
        done = eng.run()
        # one slot: the requests complete in admission order, priority
        # first, then first come
        assert [c.uid for c in done] == [1, 4, 2, 0, 3]
        assert all(len(c.tokens) == 3 for c in done)
        assert eng.allocator.free_pages == 12
        assert not eng.busy() and eng.live_generated() == {}
        assert eng.tokens_generated == 15 and eng.steps > 0

    def test_validation(self):
        config, _, tp = _model("tiny", "grouped")
        cfg = _port_config(config)
        eng = TPE.PagedServingEngine(tp, cfg, max_slots=1, num_pages=4,
                                     page_size=4, max_pages_per_seq=2,
                                     device="cpu")
        with pytest.raises(ValueError, match="capacity"):
            eng.submit(TE.Request(uid=0, prompt=np.zeros(6, np.int32),
                                  max_new_tokens=4))
        # a prompt needing more pages than the whole pool is rejected at
        # submit, not left to block the queue forever
        small = TPE.PagedServingEngine(tp, cfg, max_slots=1, num_pages=1,
                                       page_size=4, max_pages_per_seq=4,
                                       device="cpu")
        with pytest.raises(ValueError, match="pool size"):
            small.submit(TE.Request(uid=0, prompt=np.zeros(8, np.int32),
                                    max_new_tokens=2))
        # and one that slipped past validation stops run() with an error
        req = TE.Request(uid=1, prompt=np.zeros(8, np.int32),
                         max_new_tokens=2)
        small._requests[1] = req
        small.sched.submit(1, 8, 2)
        with pytest.raises(RuntimeError, match="no progress"):
            small.run()

    def test_engine_rules(self):
        config, _, tp = _model("tiny", "grouped")
        cfg = _port_config(config)
        with pytest.raises(ValueError, match="flash_attn"):
            TPE.PagedServingEngine(tp, cfg, flash_attn=True, device="cpu")
        with pytest.raises(ValueError, match="fused"):
            TPE.PagedServingEngine(object(), cfg, device="cpu")
        _, _, tparams = _params("tiny")
        eng = TPE.PagedServingEngine(tparams, cfg, num_pages=6, page_size=8,
                                     device="cpu")
        # one scratch page beyond the allocator's pages on the fused path
        assert eng.fused and eng.pool.num_pages == 7 and eng.scratch_page == 6
        assert eng.max_pages == cfg.max_seq_len // 8
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                TPE.PagedServingEngine(tparams, cfg)
