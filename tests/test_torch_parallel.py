"""PyTorch port, tensor parallelism (``parallel/`` and ``serve/tp_engine.py``)
against the single-device port and the JAX reference, on the CPU.

The port's side runs in one spawned world of two gloo ranks
(``parallel.bootstrap.launch`` over a ``file://`` store in ``tmp_path``;
``tests/torch_parallel_worker.py::world_tp2``, which imports no JAX), all
of its cases in one spawn on one torch thread a rank. The reference runs in
the pytest process on the conftest's 8-device CPU mesh, its Pallas kernels
in interpret mode. Params are the reference's
``bench.build_compressed_llama_params(TINY, rank=16, seed=0)``, stacked and
fused, handed to the ranks through ``interop``.

Bounds:
- the fused TP step against the port's single-device step: every K/V code
  equal and the logits within the reference's own 2e-6
  (``tests/test_tp_fused.py``); the same for the paged pair (ROADMAP R1);
- against the reference's TP functions: ``tests/test_torch_fused.py``'s
  logit bounds, where the single-device pair needs no rounding replay
  (``_step_both``); else the chain through the two single-device steps;
- the factor paths "l" and "lr" under TP (``tiny-l``, ``tiny-lr``,
  ``tiny-mha-l``): code-equal to the single-device step, logits within
  2e-6; against the reference's TP step within
  ``tests/test_torch_factor_paths.py``'s bounds;
- pp=2 against the single-device step and against the reference's pp=2
  steps (``decode_step_fused_pp``, ``decode_step_w4a8_pp``):
  ``tests/test_pp.py``'s 2e-4, K/V codes equal, where the single-device
  pair needs no rounding replay; else the chain through the two
  single-device steps;
- the catalog's DTensor forward: ``tests/test_serve_and_parallel.py``'s
  sharded-forward bound (rtol 1e-2, atol 5e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import bench
import torch_parallel_worker as W
from ee274_convexcaldera_llm_quantization_tpu.models import llama as JL
from ee274_convexcaldera_llm_quantization_tpu.models.config import TINY
from ee274_convexcaldera_llm_quantization_tpu.ops import kernels as JK
from ee274_convexcaldera_llm_quantization_tpu.parallel import (
    pp as JPP, tp_decode as JTPD, tp_fused as JTPF, tp_kernels as JTPK)
from ee274_convexcaldera_llm_quantization_tpu.serve import engine as JE
from ee274_convexcaldera_llm_quantization_tpu.serve import paged as JP
from ee274_convexcaldera_llm_quantization_tpu.serve import tp_engine as JTE
from ee274_convexcaldera_llm_quantization_tpu_torch.interop import (
    stacked_params_from_numpy)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused as TF
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import (
    bootstrap, pp as TPP, tp_decode as TPD, tp_fused as TPF,
    tp_kernels as TPK)

from test_torch_factor_paths import (
    FACTOR_LOGIT_REL, FACTOR_MAX_FLIPS, FACTOR_RATIO_TOL)
from test_torch_fused import (  # noqa: F401 (a fixture)
    FLIP_LOGIT_REL, LOGIT_ATOL, LOGIT_RTOL, _Rounding, _assert_caches_match,
    _flatten, _one_torch_thread, _params, _port_config, _rel, _step_both)

# the reference's TP bound against its single-device step
# (tests/test_tp_fused.py: one f32 ulp of the sum over the ranks)
TP_ATOL = 2e-6
# The stacked TP step casts each rank's K-partial xr to bf16 before its L
# dot (per-shard numerics, as the reference's): that cast rounds on its own
# edges, which the int8 replay does not see. Read: 2.6e-4 rel-Frobenius after
# one replayed code on the bf16 cache (the single-device pair: 7e-8). The
# bound is tests/test_torch_factor_paths.py's FACTOR_LOGIT_REL for the same
# bf16 edges before the factor dots.
XR_EDGE_REL = 1e-3
# pipeline stages against the single-device step (tests/test_pp.py)
PP_TOL = 2e-4
# The factor paths under TP (rows 5 and 6 of PERF.md section 6). On TINY
# the qkv group stays on "xla" and gate/up fuses its L factor: the permuted
# L_cat, the cut Ls and lr_stacked_supported at the local splits. On
# TINY_MHA every group fuses, so o and down take the "l" launch with the
# global act_scale and the summed xr.
FACTOR_SETS = ("tiny-l", "tiny-lr", "tiny-mha-l")
# the sharded forward against the unsharded one
# (tests/test_serve_and_parallel.py::test_sharded_forward_matches_single_device)
FWD_RTOL, FWD_ATOL = 1e-2, 5e-2


@pytest.fixture(scope="module")
def ref_params():
    """(config, the reference's stacked and fused params, the port's)."""
    config, jfused, tfused = _params("tiny")
    jstacked = bench.build_compressed_llama_params(TINY, num_bits=4,
                                                   rank=16, seed=0)
    arrays, meta = {}, {}
    _flatten(jstacked, "", arrays, meta)
    return (config, jstacked, jfused,
            stacked_params_from_numpy(arrays, meta, device="cpu"), tfused)


def _inputs():
    rng = np.random.default_rng(7)
    return dict(
        prompt=rng.integers(0, TINY.vocab_size, 6).astype(np.int64),
        paged_prompts=np.random.default_rng(2).integers(
            0, TINY.vocab_size, (2, 7)).astype(np.int64),
        paged_tokens=np.random.default_rng(3).integers(
            0, TINY.vocab_size, 2).astype(np.int64),
        engine_prompts=[np.random.default_rng(5).integers(
            0, TINY.vocab_size, n).astype(np.int32) for n in (5, 9)],
        W=np.random.default_rng(21).normal(size=(64, 128)).astype(
            np.float32) * 0.1,
        W_row=np.random.default_rng(22).normal(size=(32, 256)).astype(
            np.float32) * 0.1,
        x=np.random.default_rng(23).normal(size=(8, 128)).astype(np.float32),
        x_row=np.random.default_rng(24).normal(size=(8, 256)).astype(
            np.float32))


def _record_shards(axis, run):
    """Call ``run()`` (a fresh jit of a reference step under ``shard_map``)
    while every int8 activation rounding of each shard along ``axis`` is
    recorded: (its output, the shards' records), a record one ``(codes,
    x / scale)`` per call in the shard's call order."""
    record = ([], [])
    orig = JK.quantize_activations_int8

    def wrapped(x, *args):
        codes, scale = orig(x, *args)
        jax.debug.callback(
            lambda s, c, r: record[int(s)].append((np.array(c),
                                                   np.array(r))),
            jax.lax.axis_index(axis), codes, x.astype(jnp.float32) / scale,
            ordered=False)
        return codes, scale

    JK.quantize_activations_int8 = wrapped
    jax.clear_caches()
    try:
        out = run()
        jax.effects_barrier()
    finally:
        JK.quantize_activations_int8 = orig
        jax.clear_caches()
    return out, record


def _stacked_tp_reference(jstacked, config, mesh, cache_cls):
    """The reference's stacked TP step from an empty cache, its roundings
    recorded (:func:`_record_shards`): (logits, cache, the shards'
    records)."""
    step = jax.jit(JTPD.decode_step_w4a8_tp.__wrapped__,
                   static_argnames=("config", "mesh", "axis", "interpret"))
    (out, cache), record = _record_shards("tp", lambda: step(
        JTPD.shard_stacked_model_tp(jstacked, mesh),
        jnp.asarray([1, 2], jnp.int32), jnp.asarray([3, 5], jnp.int32),
        JTPD.shard_kv_cache_tp(cache_cls.create(config, 2, 16), mesh),
        config, mesh, interpret=True))
    return np.asarray(out), jax.device_get(cache), record


_PP_TOKENS = np.asarray([1, 2, 3, 4], np.int32)
_PP_POS = np.asarray([3, 5, 2, 7], np.int32)


def _stacked_pp_reference(jstacked, config, cache_cls):
    """The reference's stacked pp=2 step at the PP cases' inputs, its
    roundings recorded per stage (:func:`_record_shards`): (logits, cache,
    the stages' records)."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    step = jax.jit(JPP.decode_step_w4a8_pp.__wrapped__,
                   static_argnames=("config", "mesh", "axis", "interpret"))
    (out, cache), record = _record_shards("pp", lambda: step(
        JPP.shard_stacked_model_pp(jstacked, mesh), jnp.asarray(_PP_TOKENS),
        jnp.asarray(_PP_POS),
        JPP.shard_kv_cache_pp(cache_cls.create(config, 4, 16), mesh),
        config, mesh, interpret=True))
    return np.asarray(out), jax.device_get(cache), record


@pytest.fixture(scope="module")
def stacked_ref(ref_params, mesh2):
    config, jstacked = ref_params[:2]
    return {name: _stacked_tp_reference(jstacked, config, mesh2, cls)
            for name, cls in (("bf16", JL.KVCache),
                              ("quant", JL.QuantKVCache))}


@pytest.fixture(scope="module")
def stacked_pp_ref(ref_params):
    config, jstacked = ref_params[:2]
    return {f"stacked_{name}": _stacked_pp_reference(jstacked, config, cls)
            for name, cls in (("bf16", JL.KVCache),
                              ("quant", JL.QuantKVCache))}


@pytest.fixture(scope="module")
def world(ref_params, stacked_ref, stacked_pp_ref, tmp_path_factory):
    """The two ranks' results (rank 0's, rank 1's)."""
    config, _, _, tstacked, tfused = ref_params
    d = tmp_path_factory.mktemp("world_tp2")
    inp = dict(_inputs(), config=_port_config(config), fused=tfused,
               stacked=tstacked,
               stacked_ref={k: v[2] for k, v in stacked_ref.items()},
               stacked_pp_ref={k: v[2] for k, v in stacked_pp_ref.items()},
               factor_sets={name: (_port_config(_params(name)[0]),
                                   _params(name)[2])
                            for name in FACTOR_SETS})
    torch.save(inp, d / "inputs.pt")
    return bootstrap.launch(W.world_tp2, 2, str(d),
                            args=(str(d / "inputs.pt"),), timeout=600)


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.asarray(jax.devices()[:2]), ("tp",))


def _same_on_ranks(world, *keys):
    vals = []
    for r in world:
        v = r
        for k in keys:
            v = v[k]
        vals.append(v)
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


# ---------------------------------------------------------------------------
# Sharding transforms, byte for byte
# ---------------------------------------------------------------------------

class TestShardingBytes:
    @pytest.mark.parametrize("num_bits,shards", [
        (4, 1), (4, 2), (4, 4), (2, 2), (2, 4), (8, 2)])
    def test_repack_equals_reference(self, num_bits, shards):
        rng = np.random.default_rng(num_bits * 10 + shards)
        packed = rng.integers(0, 256, (3, 16, 256 * num_bits // 8),
                              dtype=np.uint8)
        ref = np.asarray(JTPD.repack_row_parallel_stacked(
            jnp.asarray(packed), num_bits, shards))
        got = TPD.repack_row_parallel_stacked(torch.from_numpy(packed),
                                              num_bits, shards).numpy()
        np.testing.assert_array_equal(got, ref)
        nb = got.shape[-1] // shards
        for s in range(shards):
            np.testing.assert_array_equal(TPD._repack_local(
                torch.from_numpy(packed), num_bits, shards, s).numpy(),
                ref[..., s * nb:(s + 1) * nb])
        flat = TPD.repack_row_parallel_stacked(torch.from_numpy(packed[0]),
                                               num_bits, shards).numpy()
        np.testing.assert_array_equal(flat, ref[0])

    def test_repack_rejects_indivisible(self):
        with pytest.raises(ValueError, match="not divisible"):
            TPD.repack_row_parallel_stacked(
                torch.zeros((1, 4, 48), dtype=torch.uint8), 4, 5)

    @pytest.mark.parametrize("num_bits,shards", [(4, 2), (4, 4), (2, 2)])
    def test_pack_rowscale_sharded_equals_reference(self, num_bits, shards):
        W = np.random.default_rng(shards).normal(size=(32, 256)).astype(
            np.float32) * 0.1
        jp, js = JTPK.pack_rowscale_sharded(jnp.asarray(W), num_bits, shards)
        tp, ts = TPK.pack_rowscale_sharded(torch.from_numpy(W), num_bits,
                                           shards)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    @pytest.mark.parametrize("splits,tp", [((8, 4, 4), 2), ((128, 64, 64), 2),
                                           ((256, 256), 4), ((12, 12), 3)])
    def test_group_permutation_equals_reference(self, splits, tp):
        np.testing.assert_array_equal(TPF._group_permutation(splits, tp),
                                      JTPF._group_permutation(splits, tp))

    def test_permuted_groups_equal_reference(self, ref_params):
        config, _, jfused, _, tfused = ref_params
        for name in ("qkv", "gateup"):
            jg = JTPF._shard_col_group(getattr(jfused.layers, name), 2)
            tg = TPF._shard_col_group(getattr(tfused.layers, name), 2)
            assert tg.splits == jg.splits
            for f in ("packed", "scales", "L_cat", "L_scale_cat", "b"):
                a, b = getattr(jg, f), getattr(tg, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            # each rank's block of the permuted group, gathered directly
            for r in range(2):
                loc = TPF._local_col_group(getattr(tfused.layers, name), 2, r)
                n = sum(tg.splits)
                np.testing.assert_array_equal(
                    loc.packed.numpy(),
                    tg.packed[:, r * n:(r + 1) * n].numpy())


# ---------------------------------------------------------------------------
# The fused step
# ---------------------------------------------------------------------------

class TestFusedTP:
    def test_step_matches_single_device(self, world):
        step = world[0]["fused"]["step"]
        _same_on_ranks(world, "fused", "step", "tp")
        diff = np.abs(step["tp"] - step["single"]).max()
        assert diff <= TP_ATOL, diff
        for r in world:
            # every K/V code of the rank's heads equals the single-device
            # step's; the scales too (absmax of the same K/V rows)
            assert r["fused"]["step"]["codes"] == 0
            assert r["fused"]["step"]["scale_rel"] <= 1e-6

    @pytest.mark.parametrize("flash", [0, 1])
    def test_prefill_then_decode_matches_single_device(self, world, flash):
        for r in world:
            case = r["fused"][f"prefill_decode_flash{flash}"]
            for i, row in enumerate(case["rows"]):
                assert row["logits"] <= TP_ATOL, (i, row)
                assert row["codes"] == 0, (i, row)
            assert case["tp"] == case["single"]

    def test_step_matches_reference(self, world, mesh2):
        _tp_step_vs_reference("tiny", world[0]["fused"]["step"],
                              [r["fused"]["step"] for r in world], mesh2)

    @pytest.mark.parametrize("name", FACTOR_SETS)
    def test_factor_path_step_matches_single_device(self, world, name):
        _same_on_ranks(world, "factor", name, "tp")
        for r in world:
            step = r["factor"][name]
            assert np.abs(step["tp"] - step["single"]).max() <= TP_ATOL
            assert step["codes"] == 0
            assert step["scale_rel"] <= 1e-6

    @pytest.mark.parametrize("name", FACTOR_SETS)
    def test_factor_path_step_matches_reference(self, world, mesh2, name):
        _tp_step_vs_reference(name, world[0]["factor"][name],
                              [r["factor"][name] for r in world], mesh2,
                              ratio_tol=FACTOR_RATIO_TOL,
                              max_flips=FACTOR_MAX_FLIPS,
                              logit_rel=FACTOR_LOGIT_REL)


def _tp_step_vs_reference(name, port, ranks, mesh2, logit_rel=None, **kw):
    """The port's fused TP step from the empty cache (``port``: rank 0's
    results, ``ranks``: every rank's) against the reference's
    ``decode_step_fused_tp`` on the same params and inputs. Where the
    single-device pair rounds every code alike, directly: the logits within
    ``test_torch_fused.py``'s bounds (``logit_rel`` rel-Frobenius where
    given) and every K code equal. Else through the chain: the port's TP
    step equals its single-device step (the tests above), which the replay
    holds to the reference's single-device step, which the reference's TP
    step equals (asserted here)."""
    config, jfused, tfused = _params(name)
    toks = np.asarray([1, 2], np.int32)
    pos = np.asarray([3, 5], np.int32)
    jtp = JTPF.shard_fused_model_tp(jfused, mesh2)
    jcache = JTPF.shard_headmajor_cache_tp(
        JL.HeadMajorQuantKVCache.create(config, 2, 16), mesh2)
    jout, jcache = JTPF.decode_step_fused_tp(
        jtp, jnp.asarray(toks), jnp.asarray(pos), jcache, config, mesh2,
        interpret=True)
    jout = np.asarray(jout)
    jk = np.asarray(jax.device_get(jcache.k))
    # the single-device pair, each rounding flip replayed
    with _Rounding() as rec:
        jl, jsingle, _, readings = _step_both(
            rec, (config, jfused, tfused), toks, pos,
            JL.HeadMajorQuantKVCache.create(config, 2, 16),
            TL.HeadMajorQuantKVCache.create(_port_config(config), 2, 16,
                                            device="cpu"),
            staged_kv="uniform", logit_rel=logit_rel, **kw)
    port_k = np.concatenate([r["cache"]["k"] for r in ranks], axis=2)
    print(f"\nTP step {name}: port TP / reference TP max |d| "
          f"{np.abs(port['tp'] - jout).max():.2e} (rel "
          f"{_rel(port['tp'], jout):.2e}); reference TP / single "
          f"{np.abs(jout - jl).max():.2e}; single pair "
          f"{readings['flips']} codes replayed")
    # the reference's TP against its single-device step (its own claim)
    assert np.abs(jout - jl).max() <= TP_ATOL
    np.testing.assert_array_equal(jk, np.asarray(jsingle.k))
    if readings["flips"] == 0:
        if logit_rel is None:
            np.testing.assert_allclose(port["tp"], jout, rtol=LOGIT_RTOL,
                                       atol=LOGIT_ATOL)
        else:
            assert _rel(port["tp"], jout) <= logit_rel
        np.testing.assert_array_equal(port["tp"].argmax(-1),
                                      jout.argmax(-1))
        np.testing.assert_array_equal(port_k, jk)
    else:
        assert np.abs(port["tp"] - port["single"]).max() <= TP_ATOL


# ---------------------------------------------------------------------------
# The stacked step (per-shard activation absmax on both sides)
# ---------------------------------------------------------------------------

class TestStackedTP:
    @pytest.mark.parametrize("cache", ["bf16", "quant"])
    def test_decode_matches_reference(self, stacked_ref, world, cache):
        # each rank quantizes its o/down inputs with its own absmax on both
        # sides; an activation code either side rounds the other way is
        # replayed with the reference's (test_torch_fused.py::_replay,
        # coordinated over the ranks: torch_parallel_worker._replayed)
        # before the tight bound
        jout, jc, _ = stacked_ref[cache]
        case = world[0]["stacked"][f"decode_{cache}"]
        got = _same_on_ranks(world, "stacked", f"decode_{cache}", "logits")
        tcache = {n: torch.from_numpy(np.concatenate(
            [r["stacked"][f"decode_{cache}"]["cache"][n] for r in world],
            axis=3)) for n in world[0]["stacked"][f"decode_{cache}"]["cache"]}
        tcls = TL.KVCache if cache == "bf16" else TL.QuantKVCache
        kdiff = float(np.abs(tcache["k"].float().numpy()
                             - np.asarray(jc.k, np.float32)).max())
        rel = _rel(got, jout)
        print(f"\nstacked TP {cache}: {case['flips']} codes replayed "
              f"(largest flip {case['worst']:.2e}); logits rel-Frobenius "
              f"{_rel(case['before'], jout):.2e} before the replay, "
              f"{rel:.2e} after; K cache max diff {kdiff:.2e}")
        assert rel <= XR_EDGE_REL, rel
        np.testing.assert_array_equal(got.argmax(-1), jout.argmax(-1))
        assert _rel(case["before"], jout) <= FLIP_LOGIT_REL
        _assert_caches_match(tcls(**tcache), jc)

    def test_prefill_matches_reference(self, ref_params, world, mesh2):
        config, jstacked, _, _, _ = ref_params
        jtp = JTPD.shard_stacked_model_tp(jstacked, mesh2)
        jc = JTPD.shard_kv_cache_tp(JL.KVCache.create(config, 1, 16), mesh2)
        jout, jc = JTPD.prefill_into_slot_w4a8_tp(
            jtp, jnp.asarray(_inputs()["prompt"], jnp.int32)[None],
            jnp.asarray(0), jc, config, mesh2, interpret=True,
            last_pos=jnp.asarray(4))
        got = _same_on_ranks(world, "stacked", "prefill", "logits")
        np.testing.assert_allclose(got, np.asarray(jout), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# Paged TP (settles ROADMAP R1 for the port)
# ---------------------------------------------------------------------------

class TestPagedTP:
    def test_matches_single_device(self, world):
        for r in world:
            p = r["paged"]
            for pre in p["prefill"]:
                assert np.abs(pre["tp"] - pre["single"]).max() <= TP_ATOL
            assert p["prefill_codes"] == 0
            # the paged step quantizes o/down with the global absmax too:
            # code-equal, within one f32 ulp of the sum over the ranks
            assert np.abs(p["decode"]["tp"]
                          - p["decode"]["single"]).max() <= TP_ATOL
            assert p["decode"]["codes"] == 0

    def test_matches_reference(self, ref_params, world, mesh2):
        config, _, jfused, _, _ = ref_params
        inp = _inputs()
        jtp = JTPF.shard_fused_model_tp(jfused, mesh2)
        pool = JTPF.shard_paged_pool_tp(
            JP.PagedQuantKVPool.create(config, 5, 16), mesh2)
        tables = jnp.asarray([[0, 1], [2, 3]], jnp.int32)
        for b in range(2):
            lg, pool = JTPF.paged_prefill_fused_tp(
                jtp, jnp.asarray(inp["paged_prompts"][b:b + 1], jnp.int32),
                pool, tables[b], config, mesh2, interpret=True)
            np.testing.assert_allclose(world[0]["paged"]["prefill"][b]["tp"],
                                       np.asarray(lg), rtol=LOGIT_RTOL,
                                       atol=LOGIT_ATOL)
        out, _ = JTPF.paged_decode_step_fused_tp(
            jtp, jnp.asarray(inp["paged_tokens"], jnp.int32),
            jnp.full((2,), 7, jnp.int32), pool, tables, config, mesh2,
            interpret=True)
        got = _same_on_ranks(world, "paged", "decode", "tp")
        np.testing.assert_allclose(got, np.asarray(out), rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)

    def test_active_mask_writes_scratch_only(self, world):
        for r in world:
            a = r["paged"]["active"]
            assert np.isfinite(a["logits"]).all()
            # the inactive row committed to the scratch page 4
            assert (a["scratch"][:, :, 0] > 0).all()
            assert (a["untouched"] == 0).all()


# ---------------------------------------------------------------------------
# Pipeline stages, the engine, the kernels, the DTensor catalog
# ---------------------------------------------------------------------------

class TestPipelineTwoStages:
    @pytest.mark.parametrize("case", ["fused", "stacked_bf16",
                                      "stacked_quant"])
    def test_matches_single_device(self, world, case):
        for r in world:
            c = r["pp2"][case]
            np.testing.assert_allclose(c["tp"], c["single"], rtol=PP_TOL,
                                       atol=PP_TOL)
            if case == "fused":
                assert c["codes"] == 0
            else:
                assert c["cache"] <= PP_TOL


    def test_fused_matches_reference(self, ref_params, world):
        config, _, jfused, _, tfused = ref_params
        _pp_vs_reference((config, jfused, tfused),
                         [r["pp2"]["fused"] for r in world],
                         Mesh(np.asarray(jax.devices()[:2]), ("pp",)))

    @pytest.mark.parametrize("cache", ["bf16", "quant"])
    def test_stacked_matches_reference(self, stacked_pp_ref, world, cache):
        # each stage's int8 activation codes that round the other way than
        # the reference's stage are replayed with the reference's
        # (torch_parallel_worker._replayed over the stage group) before the
        # bound of tests/test_pp.py
        case = f"stacked_{cache}"
        jout, jcache, _ = stacked_pp_ref[case]
        got = _same_on_ranks(world, "pp2", case, "replayed")
        c = world[0]["pp2"][case]
        print(f"\nPP {case}: {c['flips']} codes replayed; port / reference "
              f"max |d| {np.abs(c['tp'] - jout).max():.2e} before the "
              f"replay, {np.abs(got - jout).max():.2e} after")
        np.testing.assert_allclose(got, jout, rtol=PP_TOL, atol=PP_TOL)
        np.testing.assert_array_equal(got.argmax(-1), jout.argmax(-1))
        assert _rel(c["tp"], jout) <= FLIP_LOGIT_REL
        _assert_kv(_stage_caches([r["pp2"][case]["kv_replayed"]
                                  for r in world], 1), jcache)


def _stage_caches(kvs, tp):
    """The ranks' stage-local caches (``kvs``, stage ``s`` at ranks
    ``s * tp ..``) put back together: stages on the layer axis, tp ranks on
    the kv-head axis (head-major: dim 2)."""
    stages = [kvs[s * tp:(s + 1) * tp] for s in range(len(kvs) // tp)]
    return {n: np.concatenate([np.concatenate([c[n] for c in st], axis=2)
                               for st in stages], axis=0)
            for n in stages[0][0]}


def _assert_kv(kv, jcache):
    """int8 K/V codes equal; bf16 K/V within ``_assert_caches_match``'s
    bound."""
    for n in ("k", "v"):
        ref = np.asarray(getattr(jcache, n))
        if ref.dtype == np.int8:
            np.testing.assert_array_equal(kv[n], ref)
        else:
            np.testing.assert_allclose(kv[n], ref.astype(np.float32),
                                       rtol=2 ** -7, atol=1e-3)


def _pp_vs_reference(params, ranks, mesh, tp_axis=None):
    """The port's fused pipeline step (``ranks``: every rank's results)
    against the reference's ``decode_step_fused_pp`` on ``mesh`` (pp, or
    pp x tp with ``tp_axis``) with the same params and inputs: directly
    where the single-device pair rounds every code alike
    (``tests/test_pp.py``'s 2e-4, K/V codes equal); else within
    ``FLIP_LOGIT_REL``, the bound of a step before its replay, and through
    the chain: the port's PP step holds to its single-device step (the
    tests of the single-device comparison), which the replay holds to the
    reference's, which holds to the reference's PP step (asserted
    here)."""
    config, jfused, tfused = params
    toks, pos = jnp.asarray(_PP_TOKENS), jnp.asarray(_PP_POS)
    cache = JL.HeadMajorQuantKVCache.create(config, 4, 16)
    if tp_axis is None:
        jout, jcache = JPP.decode_step_fused_pp(
            JPP.shard_fused_model_pp(jfused, mesh), toks, pos,
            JPP.shard_kv_cache_pp(cache, mesh), config, mesh,
            interpret=True)
    else:
        spec = P("pp", None, "tp", None)
        cache = jax.tree.map(
            lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), cache,
            JL.HeadMajorQuantKVCache(P(*spec, None), P(*spec, None), spec,
                                     spec))
        jout, jcache = JPP.decode_step_fused_pp(
            JPP.shard_fused_model_pp_tp(jfused, mesh), toks, pos, cache,
            config, mesh, interpret=True, tp_axis=tp_axis)
    jout, jcache = np.asarray(jout), jax.device_get(jcache)
    # the single-device pair, each rounding flip replayed
    with _Rounding() as rec:
        jl, _, _, readings = _step_both(
            rec, params, _PP_TOKENS, _PP_POS,
            JL.HeadMajorQuantKVCache.create(config, 4, 16),
            TL.HeadMajorQuantKVCache.create(_port_config(config), 4, 16,
                                            device="cpu"),
            staged_kv=True)
    flips = readings["flips"]
    got = ranks[0]["tp"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["tp"], got)
    kv = _stage_caches([r["kv"] for r in ranks],
                       1 if tp_axis is None else mesh.shape[tp_axis])
    print(f"\nPP fused{'' if tp_axis is None else ' x TP'}: port / "
          f"reference max |d| {np.abs(got - jout).max():.2e}; reference / "
          f"single {np.abs(jout - jl).max():.2e}; single pair {flips} codes "
          "replayed")
    # the reference's PP against its single-device step (tests/test_pp.py)
    np.testing.assert_allclose(jout, jl, rtol=PP_TOL, atol=PP_TOL)
    if flips:
        # un-replayed, the flips cascade: test_torch_fused.py's bound for
        # a step before its replay
        assert _rel(got, jout) <= FLIP_LOGIT_REL, _rel(got, jout)
        return
    np.testing.assert_allclose(got, jout, rtol=PP_TOL, atol=PP_TOL)
    np.testing.assert_array_equal(got.argmax(-1), jout.argmax(-1))
    _assert_kv(kv, jcache)


class TestTPServingEngine:
    def test_matches_fast_engine(self, world):
        for r in world:
            e = r["engines"]
            assert e["fused_flash1"]["tp"] == e["fused_flash1"]["single"]
            assert e["stacked"]["tp"] == e["stacked"]["single"]
        assert world[0]["engines"] == world[1]["engines"]

    def test_matches_reference_engine(self, ref_params, world, mesh2):
        config, jstacked, _, _, _ = ref_params
        eng = JTE.TPServingEngine(jstacked, config, mesh2, max_slots=2,
                                  max_seq_len=32, interpret=True)
        for uid, p in enumerate(_inputs()["engine_prompts"]):
            eng.submit(JE.Request(uid=uid, prompt=p, max_new_tokens=5))
        ref = {c.uid: list(c.tokens) for c in eng.run()}
        assert world[0]["engines"]["fused_flash0"]["tp"] == ref


class TestTPKernels:
    def test_column_parallel_equals_single_device(self, world):
        for r in world:
            np.testing.assert_array_equal(r["kernels"]["col"],
                                          r["kernels"]["col_ref"])

    def test_row_parallel_matches_reference(self, world):
        inp = _inputs()
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("tp",))
        packed, rs = JTPK.pack_rowscale_sharded(jnp.asarray(inp["W_row"]), 4,
                                                2)
        ref = JTPK.row_parallel_w4a8(mesh, 4, interpret=True)(
            jnp.asarray(inp["x_row"]), packed, rs)
        got = _same_on_ranks(world, "kernels", "row")
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6,
                                   atol=1e-6 * np.abs(got).max())


class TestDTensorCatalog:
    @pytest.mark.parametrize("name", ["dense", "compressed"])
    def test_sharded_forward_matches_unsharded(self, world, name):
        for r in world:
            c = r["dtensor"][name]
            np.testing.assert_allclose(c["got"], c["ref"], rtol=FWD_RTOL,
                                       atol=FWD_ATOL)
        c = world[0]["dtensor"]["dense"]
        # q_proj column-parallel: half the output rows on each rank
        assert c["local_q"] == (TINY.q_dim // 2, TINY.hidden_size)


class TestRules:
    def test_local_config_divisibility(self):
        cfg = _port_config(TINY)
        with pytest.raises(ValueError, match="not divisible"):
            TPD._local_config(cfg, 3)        # 2 kv heads
        with pytest.raises(ValueError, match="not divisible"):
            TPD._local_config(dataclasses.replace(cfg, vocab_size=255), 2)
        assert TPD._local_config(cfg, 2).num_kv_heads == 1

    def test_row_parallel_bias_rejected(self, ref_params):
        _, _, _, tstacked, tfused = ref_params
        lp = tfused.layers
        bad = dataclasses.replace(tfused, layers=dataclasses.replace(
            lp, down_proj=dataclasses.replace(
                lp.down_proj, b=torch.zeros(lp.down_proj.packed.shape[:2]))))
        with pytest.raises(ValueError, match="bias"):
            TPF._local_fused(bad, 2, 0)
        # the steps refuse it before any collective
        cfg = _port_config(TINY)
        cache = TL.HeadMajorQuantKVCache.create(cfg, 1, 8, device="cpu")
        with pytest.raises(ValueError, match="bias"):
            TF.decode_step_fused(bad, torch.tensor([1]),
                                 torch.tensor([0], dtype=torch.int32), cache,
                                 cfg, tp_axis=object())
        with pytest.raises(ValueError, match="megakernels"):
            TF.decode_step_fused(tfused, torch.tensor([1]),
                                 torch.tensor([0], dtype=torch.int32), cache,
                                 cfg, tp_axis=object(), mlp_kernel=True)

    def test_pipeline_divisibility(self):
        cfg = _port_config(TINY)
        with pytest.raises(ValueError, match="not divisible"):
            TPP._stages(cfg, 3, 2)
        with pytest.raises(ValueError, match="not divisible"):
            TPP._stages(cfg, 4, 4)           # 2 layers


def test_parallel_modules_load_no_jax():
    # the ranks import these (and the worker module) by name in fresh
    # interpreters: none may pull in JAX or the JAX package
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import torch_parallel_worker\n"
        "import ee274_convexcaldera_llm_quantization_tpu_torch.parallel."
        "bootstrap, ee274_convexcaldera_llm_quantization_tpu_torch."
        "serve.tp_engine, ee274_convexcaldera_llm_quantization_tpu_torch."
        "evalm.perplexity\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or "
        "m.startswith('ee274_convexcaldera_llm_quantization_tpu.') or "
        "m == 'ee274_convexcaldera_llm_quantization_tpu')\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.path.join(root, "tests")]))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
