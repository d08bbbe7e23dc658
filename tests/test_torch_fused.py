"""PyTorch port, the W4A8 fused decode step as a whole, against the JAX
reference's ``decode_step_fused`` (Pallas kernels in interpret mode).

Params come from the reference's ``bench.build_compressed_llama_params``,
fused and int8-factored by the reference, flattened to numpy and loaded with
the port's ``fused_params_from_numpy``; prompts are drawn with numpy. Each
step starts both programs from the reference's cache, and a code the two
programs round to different sides of an edge is replayed with the
reference's rounding before the step is held to the tight bound
(:func:`_step_both`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bench
from ee274_convexcaldera_llm_quantization_tpu.models import fused as JF
from ee274_convexcaldera_llm_quantization_tpu.models import llama as JL
from ee274_convexcaldera_llm_quantization_tpu.models.config import (
    TINY, TINY_MHA, ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu.ops import attention as JA
from ee274_convexcaldera_llm_quantization_tpu.ops import kernels as JK
from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
from ee274_convexcaldera_llm_quantization_tpu_torch.interop import (
    fused_params_from_numpy)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused as TF
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    config as TC)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as TK

# logits: the JAX suite's fused-path bound (tests/test_flash_attention.py)
LOGIT_RTOL, LOGIT_ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs six workers that share the CPU with XLA's own thread
    pool; torch's default of one thread per core oversubscribes it
    (tests/test_torch_prefill.py: 47 s alone, 729 s in the parallel suite).
    These tiny shapes gain nothing from more threads. Modules that import
    this fixture use it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flatten(obj, prefix, arrays, meta):
    def key(name):
        return f"{prefix}.{name}" if prefix else name
    if obj is None:
        return
    if isinstance(obj, (jax.Array, np.ndarray)):
        arrays[prefix] = np.asarray(obj)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if f.metadata.get("static"):
                meta[key(f.name)] = value
            else:
                _flatten(value, key(f.name), arrays, meta)
    elif hasattr(obj, "_fields"):
        for name in obj._fields:
            _flatten(getattr(obj, name), key(name), arrays, meta)
    elif isinstance(obj, (tuple, list)):
        for i, value in enumerate(obj):
            _flatten(value, key(str(i)), arrays, meta)
    else:
        raise TypeError(f"cannot flatten {type(obj).__name__} at {prefix}")


def _jax_params(config, rank=16, factor_kernel=False):
    p = bench.build_compressed_llama_params(config, num_bits=4, rank=rank,
                                            seed=0)
    return JF.quantize_factors_int8_fused(JF.fuse_stacked(p),
                                          fuse_factor_kernel=factor_kernel)


def _to_port(jparams, device="cpu"):
    arrays, meta = {}, {}
    _flatten(jparams, "", arrays, meta)
    return fused_params_from_numpy(arrays, meta, device=device)


# The reference's fused attention + o_proj test model (tests/
# test_flash_attention.py::TestDecodeStepAttnO): MHA, hidden 512, head_dim
# 128, two layers.
MHA_512 = ModelConfig(vocab_size=256, hidden_size=512, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
                      max_seq_len=64)

# name -> (config, rank, factor path). On TINY the qkv group fails
# lr_stacked_supported (its k/v splits of 64 rows halve the common block
# below 128), so "l"/"lr" there fuse gate/up only and o/down stay on the
# "xla" path; the MHA configs fuse every group.
_PARAM_SETS = {"tiny": (TINY, 16, False), "tiny-mha": (TINY_MHA, 16, False),
               "tiny-l": (TINY, 128, "l"), "tiny-lr": (TINY, 128, "lr"),
               "tiny-mha-l": (TINY_MHA, 128, "l"),
               "tiny-mha-lr": (TINY_MHA, 128, "lr"),
               "mha512-l": (MHA_512, 128, "l")}
_PARAMS = {}


def _params(name):
    if name not in _PARAMS:
        config, rank, fk = _PARAM_SETS[name]
        jp = _jax_params(config, rank, fk)
        _PARAMS[name] = (config, jp, _to_port(jp))
    return _PARAMS[name]


def _port_config(config):
    return TC.ModelConfig(**dataclasses.asdict(config))


def _assert_caches_match(tc, jc, scale_rtol=LOGIT_RTOL):
    """K/V codes equal: both caches start each step from the same state and
    a rounding flip of a K/V code is replayed with the reference's code
    (:func:`_step_both`). K/V scales are absmax / 127 of f32 rows the step
    computed, held to the step's own bound: a bf16 cast before a factor dot
    rounds on its own edges (spacing 2^-8), which the replay does not
    cover, and moved a scale by 1.2e-5 relative over these seeds. A bf16
    cache holds f32 values rounded to bf16: within one bf16 ulp, or, near
    zero, an absolute 1e-3 of these O(1) values, which covers the same
    unreplayed bf16 casts before the factor dots (3.65e-4 beyond one ulp
    read in a prefill on tiny-mha, tests/test_torch_prefill.py)."""
    if not hasattr(tc, "k_scale"):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                getattr(tc, name).float().numpy(),
                np.asarray(getattr(jc, name).astype(jnp.float32)),
                rtol=2 ** -7, atol=1e-3)
        return
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   rtol=scale_rtol)


class _Rounding:
    """Records every int8 rounding of activations and KV on both sides.

    Activations round to int8 before every W4A8 matmul and the head, and
    K/V round to int8 for the cache, so one f32 ulp of difference upstream
    (sums in another order, ``exp``, ``cos``, a bf16 cast) can put a value
    on opposite sides of a rounding edge in the two programs, and the codes
    differ by one. Within the context the reference's and the port's
    ``quantize_activations_int8`` and ``quantize_kv`` append ``(codes,
    x / scale)`` per call in call order; ``force`` maps a port call index
    to ``(mask, codes)`` that replace the port's codes there, so a step can
    be replayed with the reference's rounding at its knife edges.

    The reference records through ``jax.debug.callback`` in a fresh jit of
    ``fn`` (``decode_step_fused`` unless given, with ``static`` as its
    static arguments); JAX's caches are cleared on entry and exit so that
    no trace made before holds the recorder and none made inside outlives
    it. Calls of the reference's own jitted functions inside the context
    (an engine's) retrace and record too.

    The two megakernels requantize inside the kernel (the whole-MLP
    kernel's ``m``, the fused attention + o_proj kernel's attention
    output), where the port's plain versions call
    ``quantize_activations_int8``. Their kernel bodies are wrapped to report
    those codes from the requantizing grid step (an unordered callback:
    Pallas kernels take no ordered effects), and the kernel's wrapper
    moves them into the record in program order with an ordered callback
    on the kernel's output, which runs only after the kernel.
    """

    def __init__(self, fn=None, static=("config", "interpret", "staged_kv",
                                        "attn_dots", "attn_kernel",
                                        "mlp_kernel", "attn_o_kernel",
                                        "proj_kernel")):
        self.jax, self.port, self.force = [], [], {}
        self.pending = []
        self.fn = JF.decode_step_fused if fn is None else fn
        self.static = static

    def _jax_wrap(self, orig, kv):
        def wrapped(x, *args):
            codes, scale = orig(x, *args)
            ratio = x.astype(jnp.float32) / (scale[..., None] if kv
                                             else scale)
            jax.debug.callback(
                lambda c, r: self.jax.append((np.array(c), np.array(r))),
                codes, ratio, ordered=True)
            return codes, scale
        return wrapped

    def _port_wrap(self, orig, kv):
        def wrapped(x, *args):
            codes, scale = orig(x, *args)
            forced = self.force.get(len(self.port))
            if forced is not None:
                codes = torch.where(torch.from_numpy(forced[0]),
                                    torch.from_numpy(forced[1]), codes)
            ratio = x.float() / (scale[..., None] if kv else scale)
            self.port.append((codes.numpy().copy(), ratio.numpy().copy()))
            return codes, scale
        return wrapped

    def _kernel_wrap(self, orig, at, refs):
        """A megakernel body that also reports, at grid step ``at(kw)``,
        the int8 codes and the values / scale of its requantization
        (``refs``: the indices of the codes, values and scale refs)."""
        def body(*args, **kw):
            orig(*args, **kw)
            codes, vals, scale = (args[i] for i in refs)

            @pl.when(pl.program_id(0) == at(kw))
            def _report():
                jax.debug.callback(
                    lambda c, r: self.pending.append((np.array(c),
                                                      np.array(r))),
                    codes[:], vals[:] / scale[:, :1], ordered=False)
        return body

    def _flush_wrap(self, orig):
        """The megakernel's wrapper: after the kernel, its reported codes
        join the record, cut to the caller's M rows (the kernel pads to
        32)."""
        def wrapped(x, *args, **kw):
            out = orig(x, *args, **kw)
            rows = x.shape[0]

            def flush(_):
                self.jax.extend((c[:rows], r[:rows])
                                for c, r in self.pending)
                self.pending.clear()
            jax.debug.callback(flush, out, ordered=True)
            return out
        return wrapped

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (JK, "quantize_activations_int8"), (JL, "quantize_kv"),
            (TK, "quantize_activations_int8"), (TL, "quantize_kv"),
            (JK, "_qmm_w4a8_mlp_stacked_kernel"),
            (JA, "_flash_attn_o_kernel"),
            (JK, "quantized_matmul_w4a8_mlp_stacked"),
            (JA, "flash_decode_attn_o"))]
        for (m, n, orig), wrap in zip(self.saved[:4], (
                self._jax_wrap, self._jax_wrap, self._port_wrap,
                self._port_wrap)):
            setattr(m, n, wrap(orig, n == "quantize_kv"))
        # whole-MLP kernel: m8_ref, gm_ref, sm_ref at program G1; fused
        # attention + o_proj: xq8_ref, attn_ref, sx_ref at program B * nt
        (_, _, mlp), (_, _, attn_o), (_, _, mlp_fn), (_, _, attn_o_fn) = \
            self.saved[4:]
        JK._qmm_w4a8_mlp_stacked_kernel = self._kernel_wrap(
            mlp, lambda kw: kw["G1"], (18, 16, 19))
        JA._flash_attn_o_kernel = self._kernel_wrap(
            attn_o, lambda kw: kw["B"] * kw["nt"], (20, 19, 21))
        JK.quantized_matmul_w4a8_mlp_stacked = self._flush_wrap(mlp_fn)
        JA.flash_decode_attn_o = self._flush_wrap(attn_o_fn)
        jax.clear_caches()
        self.jax_step = jax.jit(self.fn.__wrapped__,
                                static_argnames=self.static)
        return self

    def __exit__(self, *exc):
        for m, n, orig in self.saved:
            setattr(m, n, orig)
        jax.clear_caches()
        return False


# A rounding flip: the two programs' values before rounding agree to well
# under one code and the codes differ by exactly one. An f32 ulp of a code
# is ~1e-5; a bf16 cast upstream of a factor dot left up to 9e-3 over these
# seeds (five head-input codes on one step).
FLIP_RATIO_TOL = 5e-2
# Codes a step may round the other way before the port, replayed with the
# reference's codes there, agrees within the logits bound.
MAX_FLIPS = 16
# Un-replayed, one flip cascades through the tiny random-weight model:
# 1.2e-2 relative was the largest reading over these seeds (PERF.md).
FLIP_LOGIT_REL = 3e-2


def _replay(rec, run_jax, run_port, max_flips=None, ratio_tol=None):
    """Run the reference once (``run_jax()``, recording its roundings),
    then the port (``run_port()``, which must start from the same state
    each time it is called) until it rounds every code as the reference:
    where the port rounds a code to the other side of an edge, it is rerun
    with the reference's code there (each must be a rounding flip, values
    before rounding within ``ratio_tol`` of a code, ``FLIP_RATIO_TOL``
    unless given), up to ``max_flips`` codes (``MAX_FLIPS`` unless given).
    Returns ``(reference output, port output after the replay, port output
    before it, codes replayed, the largest flip's value difference)``."""
    max_flips = MAX_FLIPS if max_flips is None else max_flips
    ratio_tol = FLIP_RATIO_TOL if ratio_tol is None else ratio_tol
    rec.jax.clear()
    jout = run_jax()
    jax.effects_barrier()
    ref_codes = list(rec.jax)
    rec.force = {}
    flips, first, worst = 0, None, 0.0
    while True:
        rec.port.clear()
        tout = run_port()
        if first is None:
            first = tout
        assert len(rec.port) == len(ref_codes) > 0
        at = next((i for i, (a, b) in enumerate(zip(ref_codes, rec.port))
                   if not np.array_equal(a[0], b[0])), None)
        if at is None:
            break
        (jc, jr), (tc, tr) = ref_codes[at], rec.port[at]
        m = jc != tc
        assert np.abs(jc[m].astype(np.int32) - tc[m]).max() == 1, at
        worst = max(worst, float(np.abs(jr[m] - tr[m]).max()))
        assert worst <= ratio_tol, (at, worst)
        rec.force[at] = (m, jc)
        flips += int(m.sum())
        assert flips <= max_flips, f"{flips} rounding flips in one call"
    rec.force = {}
    return jout, tout, first, flips, worst


def _reset(tcache, arrays):
    for name, a in zip(_fields(tcache), arrays):
        getattr(tcache, name).copy_(_torch_array(a))


def _fields(cache):
    return [f.name for f in dataclasses.fields(cache)]


def _torch_array(a):
    """numpy (bfloat16 included) -> torch, bit for bit."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _step_both(rec, params, tokens, pos, jcache, tcache, ratio_tol=None,
               max_flips=None, logit_rel=None, **kw):
    """One step of the reference and the port from the same cache.

    ``tcache`` is overwritten with ``jcache`` first; roundings are replayed
    (:func:`_replay`, flips within ``ratio_tol``, at most ``max_flips``)
    and the replay is held to the tight bound, or, where ``logit_rel`` is
    given, to that rel-Frobenius bound on the logits and that rtol on the
    K/V scales. Returns
    ``(reference logits, jcache, tcache, readings)``: the codes replayed,
    and the logits' rel-Frobenius difference before and after the
    replay."""
    config, jparams, tparams = params
    pre = [np.array(a) for a in jcache]

    def run_jax():
        return rec.jax_step(jparams, jnp.asarray(tokens), jnp.asarray(pos),
                            jcache, config, interpret=True, **kw)

    def run_port():
        _reset(tcache, pre)
        return TF.decode_step_fused(
            tparams, torch.from_numpy(tokens.astype(np.int64)),
            torch.from_numpy(pos), tcache, _port_config(config),
            **kw)[0].numpy()

    (jl, jcache), tl, first, flips, _ = _replay(
        rec, run_jax, run_port, max_flips=max_flips, ratio_tol=ratio_tol)
    jl = np.asarray(jl)
    if logit_rel is None:
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    else:
        assert _rel(tl, jl) <= logit_rel, _rel(tl, jl)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    first_rel = _rel(first, jl)
    assert first_rel <= FLIP_LOGIT_REL, first_rel
    _assert_caches_match(tcache, jcache,
                         LOGIT_RTOL if logit_rel is None else logit_rel)
    return jl, jcache, tcache, dict(flips=flips, before=first_rel,
                                    after=_rel(tl, jl))


_CACHES = {"head": (JL.HeadMajorQuantKVCache, TL.HeadMajorQuantKVCache),
           "quant": (JL.QuantKVCache, TL.QuantKVCache),
           "bf16": (JL.KVCache, TL.KVCache)}


def _loop_over_seeds(name, seeds, attn_dots="i8", cache="head", T=16,
                     ratio_tol=None, max_flips=None, logit_rel=None,
                     steps=6, **kw):
    """``steps`` steps per seeded prompt (three prompt tokens, then the
    reference's greedy tokens), each step from the reference's cache and
    held to :func:`_step_both`'s bounds (``ratio_tol``, ``max_flips``,
    ``logit_rel``)."""
    params = _params(name)
    config = params[0]
    B, prompt_len = 2, 3
    jcls, tcls = _CACHES[cache]
    readings = []
    with _Rounding() as rec:
        for seed in seeds:
            prompt = np.random.default_rng(seed).integers(
                0, config.vocab_size, size=(B, prompt_len)).astype(np.int32)
            jcache = jcls.create(config, B, T)
            tcache = tcls.create(_port_config(config), B, T, device="cpu")
            tok = prompt[:, 0]
            flip_steps, before, after = [], 0.0, 0.0
            for step in range(steps):
                pos = np.full((B,), step, np.int32)
                jl, jcache, tcache, r = _step_both(
                    rec, params, tok, pos, jcache, tcache,
                    ratio_tol=ratio_tol, max_flips=max_flips,
                    logit_rel=logit_rel, attn_dots=attn_dots, **kw)
                if r["flips"]:
                    flip_steps.append((step, r["flips"]))
                    before = max(before, r["before"])
                after = max(after, r["after"])
                tok = (prompt[:, step + 1] if step + 1 < prompt_len
                       else jl.argmax(-1).astype(np.int32))
            readings.append(f"seed {seed}: (step, codes replayed) "
                            f"{flip_steps}; logits rel-Frobenius: worst "
                            f"replayed step {before:.2e} before its replay, "
                            f"worst step {after:.2e}")
    # `pytest -s` shows the readings that PERF.md records
    print(f"\n{name} attn_dots={attn_dots} cache={cache} {kw}:\n  "
          + "\n  ".join(readings))


SEEDS = range(8)


class TestDecodeStepVsReference:
    @pytest.mark.parametrize("name", ["tiny", "tiny-mha"])
    def test_greedy_loop_matches(self, name):
        # every seeded prompt, each step held to the tight bound; steps
        # where one program rounds a code the other way are replayed with
        # the reference's rounding there (see _step_both)
        _loop_over_seeds(name, SEEDS, "i8", staged_kv="uniform")

    def test_ragged_positions_and_uniform_guard(self):
        # staged_kv=True with ragged rows, and "uniform" given ragged rows:
        # the reference's guard falls back to per-row commits, which the
        # port's indexed commit always performs
        params = _params("tiny")
        config = params[0]
        B, T = 3, 16
        with _Rounding() as rec:
            for seed in range(4):
                tokens = np.random.default_rng(100 + seed).integers(
                    0, config.vocab_size, size=(2, B)).astype(np.int32)
                for staged in (True, "uniform"):
                    jcache = JL.HeadMajorQuantKVCache.create(config, B, T)
                    tcache = TL.HeadMajorQuantKVCache.create(
                        _port_config(config), B, T, device="cpu")
                    for tok, pos in zip(tokens, ([0, 4, 9], [1, 5, 10])):
                        _, jcache, tcache, _ = _step_both(
                            rec, params, tok, np.asarray(pos, np.int32),
                            jcache, tcache, staged_kv=staged,
                            attn_dots="i8")
                    # each row's K landed at its own column
                    for b, p in enumerate([1, 5, 10]):
                        assert tcache.k_scale[0, b, :, p].min() > 0

    def test_f32_dots_match(self):
        # the f32-dots twin over the same multi-step loop: its attention
        # rounds nothing, but activations and K/V still round to int8
        for name in ("tiny", "tiny-mha"):
            _loop_over_seeds(name, SEEDS, "f32", staged_kv="uniform")

    @pytest.mark.parametrize("staged,attn_kernel,T", [
        (False, "row", 16), (False, "ab", 256), (True, "ab", 256)])
    @pytest.mark.parametrize("dots", ["i8", "f32"])
    def test_inline_and_all_batch_paths(self, staged, attn_kernel, T, dots):
        # the inline head-major path (K/V written at pos before the
        # attention) and the all-batch kernel's partition, staged and
        # inline; T = 256 gives the all-batch kernel two 128-token blocks
        _loop_over_seeds("tiny", SEEDS, dots, T=T, staged_kv=staged,
                         attn_kernel=attn_kernel)

    @pytest.mark.parametrize("cache", ["quant", "bf16"])
    def test_token_major_caches(self, cache):
        # the token-major int8 and bf16 caches: plain attention with an
        # additive mask, as the reference's XLA path
        _loop_over_seeds("tiny", SEEDS, cache=cache)

    def test_default_is_the_inline_path(self):
        # the reference's default is staged_kv=False: a default step equals
        # an explicit inline step bit for bit
        _, _, tparams = _params("tiny")
        out = []
        for kw in ({}, dict(staged_kv=False)):
            cache = TL.HeadMajorQuantKVCache.create(TC.TINY, 2, 16,
                                                    device="cpu")
            out.append(TF.decode_step_fused(
                tparams, torch.tensor([3, 7]),
                torch.tensor([0, 0], dtype=torch.int32), cache, TC.TINY,
                **kw))
        assert torch.equal(out[0][0], out[1][0])
        assert torch.equal(out[0][1].k, out[1][1].k)


class TestPortSurface:
    def test_bench_params_shapes_match_reference(self):
        jp = bench.build_compressed_llama_params(TINY, num_bits=4, rank=16,
                                                 seed=0)
        tp = bench_params.build_compressed_llama_params(
            TC.TINY, num_bits=4, rank=16, seed=0, device="cpu")
        ja, jm, ta, tm = {}, {}, {}, {}
        _flatten(jp, "", ja, jm)
        for name in ("embed", "final_norm", "lm_head.w"):
            ta[name] = getattr(tp, name) if "." not in name else tp.lm_head.w
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                     "up_proj", "down_proj"):
            lin = getattr(tp.layers, proj)
            for f in ("packed", "scales", "L", "R", "global_scale"):
                ta[f"layers.{proj}.{f}"] = getattr(lin, f)
            for f in ("num_bits", "group_size", "out_features",
                      "in_features", "mode"):
                assert getattr(lin, f) == jm[f"layers.{proj}.{f}"], (proj, f)
        for name, t in ta.items():
            assert tuple(t.shape) == ja[name].shape, name
            assert str(t.dtype).split(".")[-1] == ja[name].dtype.name, name

    def test_fuse_and_quantize_match_reference(self):
        # the port's fuse_stacked + quantize_factors_int8_fused on the
        # reference's unfused params give the reference's fused params
        jp = bench.build_compressed_llama_params(TINY, num_bits=4, rank=16,
                                                 seed=0)
        from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
            compressed as TCm, stacked as TS)

        def lin(j):
            return TCm.CalderaLinear(
                packed=torch.from_numpy(np.array(j.packed)),
                scales=torch.from_numpy(np.array(j.scales)),
                L=torch.from_numpy(np.array(j.L.astype(jnp.float32))).to(
                    torch.bfloat16),
                R=torch.from_numpy(np.array(j.R.astype(jnp.float32))).to(
                    torch.bfloat16),
                global_scale=torch.from_numpy(np.array(j.global_scale)),
                num_bits=j.num_bits, group_size=j.group_size,
                out_features=j.out_features, in_features=j.in_features,
                mode=j.mode)
        lp = jp.layers
        layers = TS.LayerParams(
            attn_norm=torch.from_numpy(np.array(lp.attn_norm)),
            mlp_norm=torch.from_numpy(np.array(lp.mlp_norm)),
            **{n: lin(getattr(lp, n)) for n in (
                "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")})
        head = TCm.DenseLinear(w=torch.from_numpy(
            np.array(jp.lm_head.w.astype(jnp.float32))).to(torch.bfloat16))
        tp = TF.quantize_factors_int8_fused(TF.fuse_stacked(TS.StackedModelParams(
            embed=torch.zeros(1), layers=layers,
            final_norm=torch.from_numpy(np.array(jp.final_norm)),
            lm_head=head)))
        ref = _params("tiny")[2]
        for g in ("qkv", "gateup"):
            a, b = getattr(tp.layers, g), getattr(ref.layers, g)
            assert (a.splits, a.ranks, a.num_bits) == (b.splits, b.ranks,
                                                        b.num_bits)
            for f in ("packed", "scales", "R", "R_scale", "global_scale"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (g, f)
            for x, y in zip(a.Ls + a.L_scales, b.Ls + b.L_scales):
                assert torch.equal(x, y), g
        assert torch.equal(tp.lm_head.w8, ref.lm_head.w8)
        assert torch.equal(tp.lm_head.scales, ref.lm_head.scales)

    def test_no_quiet_cpu_fallback(self):
        if torch.cuda.is_available():
            cache = TL.HeadMajorQuantKVCache.create(TC.TINY, 1, 8)
            assert cache.k.is_cuda
            return
        with pytest.raises(RuntimeError, match="cuda"):
            TL.HeadMajorQuantKVCache.create(TC.TINY, 1, 8)
        with pytest.raises(RuntimeError, match="cuda"):
            bench_params.build_compressed_llama_params(TC.TINY)
        with pytest.raises(RuntimeError, match="cuda"):
            _to_port(_params("tiny")[1], device="cuda")

    @pytest.mark.parametrize("flag", [
        dict(attn_kernel="ab", attn_dots="bf16"), dict(tp_axis="tp"),
        dict(proj_kernel="persistent"), dict(staged_kv=True,
                                             attn_dots="bf16"),
        dict(attn_dots="bf16")])
    def test_unported_flags_raise(self, flag):
        # every flag is ported now (their parity with the reference is in
        # tests/test_torch_proj_options.py, test_torch_bf16_dots.py and, for
        # tp_axis, test_torch_parallel.py): the persistent launch gives the
        # grid launch's logits bit for bit, bf16 dots finite logits of the
        # step's shape; tp_axis, which takes a process group, refuses the
        # megakernels before any collective, as the reference refuses them
        _, _, tparams = _params("tiny")

        def step(**kw):
            cache = TL.HeadMajorQuantKVCache.create(TC.TINY, 1, 8,
                                                    device="cpu")
            return TF.decode_step_fused(
                tparams, torch.tensor([1]),
                torch.tensor([0], dtype=torch.int32), cache, TC.TINY,
                **kw)[0]
        if "tp_axis" in flag:
            with pytest.raises(ValueError, match="megakernels"):
                step(mlp_kernel=True, **flag)
            return
        logits = step(**flag)
        assert logits.shape == (1, TC.TINY.vocab_size)
        assert bool(torch.isfinite(logits).all())
        if "proj_kernel" in flag:
            assert torch.equal(logits, step())

    def test_unknown_factor_path_raises(self):
        # the reference's names: False / "xla", "l", True / "lr"
        _, _, tparams = _params("tiny")
        with pytest.raises(ValueError, match="factor kernel"):
            TF.quantize_factors_int8_fused(tparams, fuse_factor_kernel="x")

    @pytest.mark.parametrize("name,flag,match", [
        # the reference's ValueError guards of decode_step_fused
        ("tiny", dict(mlp_kernel=True), "mlp_kernel"),
        ("tiny", dict(attn_o_kernel=True), "attn_o_kernel"),
        ("tiny-l", dict(attn_o_kernel=True), "attn_o_kernel"),
        ("mha512-l", dict(attn_o_kernel=True, attn_dots="i8"), "f32"),
        ("mha512-l", dict(attn_o_kernel=True, attn_dots="bf16"), "f32"),
        ("mha512-l", dict(attn_o_kernel=True, attn_kernel="ab"),
         "mutually exclusive"),
        ("mha512-l", dict(attn_o_kernel=True, cache="quant"),
         "attn_o_kernel")])
    def test_megakernel_guards_raise(self, name, flag, match):
        # mlp_kernel on "xla" params; attn_o on GQA (TINY), with dots other
        # than f32, with the all-batch grid, on a token-major cache
        config, jparams, tparams = _params(name)
        flag = dict(flag)
        jcls, tcls = _CACHES[flag.pop("cache", "head")]
        with pytest.raises(ValueError, match=match):
            JF.decode_step_fused(
                jparams, jnp.asarray([1], jnp.int32),
                jnp.asarray([0], jnp.int32), jcls.create(config, 1, 8),
                config, interpret=True, **flag)
        with pytest.raises(ValueError, match=match):
            TF.decode_step_fused(
                tparams, torch.tensor([1]),
                torch.tensor([0], dtype=torch.int32),
                tcls.create(_port_config(config), 1, 8, device="cpu"),
                _port_config(config), **flag)
