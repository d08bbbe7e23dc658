"""PyTorch port, the rest of the compression pipeline: the e8p branch of
``models/compressed.py``'s ``compress_linear``, ``calibrate/hessian.py``,
``models/surgery.py``, ``utils/checkpoint.py`` and ``cli.py``, against the
JAX reference on the CPU.

Weights cross over as numpy: the reference's dense ``init_params`` model
(TINY, bf16 projections) flattened and loaded with the port's
``interop.model_params_from_numpy``, so both packages calibrate and
compress the same weights; both compress with the reference's Hessians.
Checkpoints cross in both directions and must hold equal arrays."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.calibrate import hessian as JH
from ee274_convexcaldera_llm_quantization_tpu.decomp import caldera as JCal
from ee274_convexcaldera_llm_quantization_tpu.models import compressed as JC
from ee274_convexcaldera_llm_quantization_tpu.models import llama as JL
from ee274_convexcaldera_llm_quantization_tpu.models import surgery as JS
from ee274_convexcaldera_llm_quantization_tpu.models.config import TINY
from ee274_convexcaldera_llm_quantization_tpu.quant.quantizers import (
    QuantizerFactory as JQF)
from ee274_convexcaldera_llm_quantization_tpu.utils import checkpoint as JCk
from ee274_convexcaldera_llm_quantization_tpu_torch import cli as TCLI
from ee274_convexcaldera_llm_quantization_tpu_torch.calibrate import (
    hessian as TH)
from ee274_convexcaldera_llm_quantization_tpu_torch.decomp import (
    caldera as TCal)
from ee274_convexcaldera_llm_quantization_tpu_torch.interop import (
    model_params_from_numpy)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    compressed as TC)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    surgery as TS)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    TINY as T_TINY)
from ee274_convexcaldera_llm_quantization_tpu_torch.quant.quantizers import (
    QuantizerFactory as TQF)
from ee274_convexcaldera_llm_quantization_tpu_torch.utils import (
    checkpoint as TCk)

from test_torch_fused import (  # noqa: F401 (a fixture)
    _flatten, _one_torch_thread)

# TINY with q/k/v biases, so checkpoints carry bias arrays too
CONFIG = dataclasses.replace(TINY, attention_bias=True)
T_CONFIG = dataclasses.replace(T_TINY, attention_bias=True)
F32_EPS = np.finfo(np.float32).eps
# Hessians: the same f32 batch sums in another order, added in float64,
# over activations that pass bf16-rounded dots. An f32 ulp upstream can
# round a bf16 cast the other way, so the moments of the second layer's
# inputs move by up to a bf16 ulp of a few entries (read: 9e-4 relative,
# Frobenius). Bound 5e-3 relative Frobenius per matrix.
HESS_RTOL = 5e-3
# compress_model's per-projection relative errors: RTN lands on the same
# codes (f32 ulps apart; bound 1e-4 absolute); LDLQ and e8p rounding can part
# on ulps of U or of the block RMS, bound 2% relative (test_torch_caldera.py)
RTN_ATOL, LDLQ_RTOL = 1e-4, 0.02


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _jnp(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


_MODELS = {}


def _models():
    """(reference dense params, the same weights on the port, CPU), with
    nonzero biases and norms."""
    if "dense" not in _MODELS:
        rng = np.random.default_rng(0)
        jp = JL.init_params(jax.random.PRNGKey(0), CONFIG)

        def bias(lin):
            if lin.b is None:
                return lin
            return dataclasses.replace(lin, b=jnp.asarray(
                0.1 * rng.standard_normal(lin.b.shape), jnp.bfloat16))
        layers = [lp._replace(
            q_proj=bias(lp.q_proj), k_proj=bias(lp.k_proj),
            v_proj=bias(lp.v_proj),
            attn_norm=jnp.asarray(rng.uniform(0.5, 1.5, CONFIG.hidden_size),
                                  jnp.float32))
            for lp in jp.layers]
        jp = jp._replace(layers=layers)
        arrays, meta = {}, {}
        _flatten(jp, "", arrays, meta)
        _MODELS["dense"] = (jp, model_params_from_numpy(arrays, meta,
                                                        device="cpu"))
    return _MODELS["dense"]


def _batches(n=2, B=2, S=16, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CONFIG.vocab_size, size=(B, S)).astype(np.int32)
            for _ in range(n)]


def _hessians(diag):
    key = ("hess", diag)
    if key not in _MODELS:
        jp, _ = _models()
        _MODELS[key] = JH.collect_hessians(jp, _batches(), CONFIG, diag=diag)
    return _MODELS[key]


def _rel_fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# compress_linear(q_method="e8p")
# ---------------------------------------------------------------------------

class TestE8PLinear:
    def test_matches_reference(self):
        rng = np.random.default_rng(1)
        # o_proj's shape: the reference's jitted lattice pack compiles once
        # for this file
        W = rng.standard_normal((128, 128)).astype(np.float32)
        L = (0.1 * rng.standard_normal((128, 4))).astype(np.float32)
        R = (0.1 * rng.standard_normal((4, 128))).astype(np.float32)
        b = rng.standard_normal(128).astype(np.float32)
        j = JC.compress_linear(jnp.asarray(W), jnp.asarray(L), jnp.asarray(R),
                               4, global_scale=1.3, bias=jnp.asarray(b),
                               mode="w4a8", q_method="e8p")
        t = TC.compress_linear(torch.from_numpy(W), torch.from_numpy(L),
                               torch.from_numpy(R), 4, global_scale=1.3,
                               bias=torch.from_numpy(b), mode="w4a8",
                               q_method="e8p")
        # the int4 bytes are exact; scales and the offset column carry the
        # block RMS's f32 ulps (then one bf16 rounding of the offsets)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        np.testing.assert_allclose(t.scales.numpy(), np.asarray(j.scales),
                                   rtol=8 * F32_EPS)
        np.testing.assert_array_equal(_np(t.L)[:, :4], _jnp(j.L)[:, :4])
        np.testing.assert_allclose(_np(t.L)[:, 4], _jnp(j.L)[:, 4],
                                   rtol=2 ** -8)
        np.testing.assert_array_equal(_np(t.R), _jnp(j.R))
        for f in ("num_bits", "group_size", "out_features", "in_features",
                  "mode", "q_method"):
            assert getattr(t, f) == getattr(j, f), f
        x = rng.standard_normal((5, 128)).astype(np.float32)
        y = TC.apply_linear(t, torch.from_numpy(x)).numpy()
        ref = np.asarray(JC.apply_linear(j, jnp.asarray(x)))
        # int8 activations: an ulp of a scale can flip an activation code
        # (ROADMAP R6); the outputs agree to 1e-2 relative Frobenius
        assert _rel_fro(y, ref) <= 1e-2
        # the lattice reconstruction is exact in the int4 + rank-1 form
        dense = t.materialize().numpy()
        np.testing.assert_allclose(dense, np.asarray(j.materialize()),
                                   rtol=0, atol=2e-2)


# ---------------------------------------------------------------------------
# calibrate/hessian.py
# ---------------------------------------------------------------------------

class TestHessians:
    @pytest.mark.parametrize("diag", [True, False])
    def test_collect_matches_reference(self, diag):
        _, tp = _models()
        ref = _hessians(diag)
        got = TH.collect_hessians(tp, _batches(), T_CONFIG, diag=diag)
        assert sorted(got) == sorted(ref)
        assert len(got) == CONFIG.num_layers * 7
        for name, H in got.items():
            assert H.dtype == torch.float64
            assert H.shape == ref[name].shape, name
            assert _rel_fro(H.numpy(), ref[name]) <= HESS_RTOL, name
        # layer 0's q/k/v input is the embedding through RMSNorm: no dot
        # upstream, so the same f32 values summed in another order
        np.testing.assert_allclose(got["layers.0.q_proj"].numpy(),
                                   ref["layers.0.q_proj"], rtol=1e-5,
                                   atol=1e-7)

    def test_save_load_and_reference_pickle(self, tmp_path):
        _, tp = _models()
        hs = TH.collect_hessians(tp, _batches(n=1), T_CONFIG, diag=True)
        path = str(tmp_path / "h.npz")
        TH.save_hessians(path, hs)
        back = TH.load_hessians(path)
        ref = JH.load_hessians(path)
        for k in hs:
            np.testing.assert_array_equal(back[k], hs[k].numpy())
            np.testing.assert_array_equal(back[k], ref[k])
        raw = {f"language_model.model.layers.{i}.self_attn.q_proj":
               torch.arange(8, dtype=torch.float32) + i for i in range(2)}
        raw["language_model.model.layers.1.mlp.down_proj"] = torch.ones(4)
        raw["vision_tower.layers.0.q_proj"] = torch.zeros(3)
        pt = str(tmp_path / "diag_Hessians.pt")
        torch.save(raw, pt)
        got = TH.load_hessians(pt)
        want = JH.load_reference_hessians(pt)
        assert sorted(got) == sorted(want) == [
            "layers.0.q_proj", "layers.1.down_proj", "layers.1.q_proj"]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        keys = list(raw)
        assert (TS.hessian_key_map_from_reference(keys)
                == JS.hessian_key_map_from_reference(keys))


# ---------------------------------------------------------------------------
# models/surgery.py
# ---------------------------------------------------------------------------

# Two projection shapes (o: 128 x 128, down: 128 x 256) in both layers:
# the reference compiles its solver anew for each shape and setting, and
# those compiles are most of this file's time.
_TWO_SHAPES = ("o_proj", "down_proj")
_CASES = {
    "rtn": dict(cp=dict(), kw=dict(serving_mode="grouped")),
    "ldlq": dict(cp=dict(q_update="ldlq"), kw=dict(serving_mode="w4a8")),
    "e8p": dict(cp=dict(quant_factory_Q=("e8p", "global"), iters=1),
                kw=dict(serving_mode="w4a8", serving_quant="e8p"),
                projs=("o_proj",)),
    "hadamard": dict(cp=dict(), kw=dict(use_hadamard=True)),
}


def _cp(pkg, Q_bits=2, **kw):
    qf = kw.pop("quant_factory_Q", None)
    cls, qcls = ((JCal.CalderaParams, JQF) if pkg == "jax"
                 else (TCal.CalderaParams, TQF))
    if qf is not None:
        kw["quant_factory_Q"] = qcls(method=qf[0], block_size=qf[1])
    kw.setdefault("iters", 2)
    return cls(Q_bits=Q_bits, L_bits=16, R_bits=16, rank=8, lplr_iters=2,
               **kw)


def _cp_full(pkg):
    """For the full Hessians of 64 calibration tokens (rank <= 64 < n):
    their smallest eigenvalues are lifted to 0.01, as a singular H would
    divide by zero in the regression's un-whitening."""
    return _cp(pkg, sigma_reg=1e-2)


def _check_reports(jr, tr, rtol=0.0, atol=RTN_ATOL):
    assert sorted(tr.errors) == sorted(jr.errors)
    assert sorted(tr.compressed) == sorted(jr.compressed)
    assert sorted(tr.skipped) == sorted(jr.skipped)
    assert (tr.total_bits, tr.total_params) == (jr.total_bits,
                                                jr.total_params)
    assert tr.avg_bits_per_param == jr.avg_bits_per_param
    for name, e in tr.errors.items():
        assert abs(e - jr.errors[name]) <= atol + rtol * jr.errors[name], (
            name, e, jr.errors[name])


class TestSurgery:
    @pytest.mark.parametrize("case", list(_CASES))
    def test_compress_model_matches(self, case):
        jp, tp = _models()
        hs = _hessians(True)
        spec = _CASES[case]
        lr = dict(layer_range=(1, 1)) if case == "hadamard" else {}
        kw = dict(spec["kw"], proj_filter=spec.get("projs", _TWO_SHAPES),
                  **lr)
        jq, jr = JS.compress_model(jp, _cp("jax", **spec["cp"]), hessians=hs,
                                   **kw)
        tq, tr = TS.compress_model(tp, _cp("torch", **spec["cp"]),
                                   hessians=hs, **kw)
        exact = case in ("rtn", "hadamard")
        _check_reports(jr, tr, rtol=0.0 if exact else LDLQ_RTOL,
                       atol=RTN_ATOL if exact else 1e-6)
        assert tr.compressed, "nothing compressed"
        for i, (jl, tl) in enumerate(zip(jq.layers, tq.layers)):
            for name in TS.PROJ_NAMES:
                j, t = getattr(jl, name), getattr(tl, name)
                assert type(t).__name__ == type(j).__name__, (i, name)
                if isinstance(t, TC.CalderaLinear):
                    for f in ("num_bits", "group_size", "mode", "q_method",
                              "out_features", "in_features"):
                        assert getattr(t, f) == getattr(j, f)
                    assert t.L.shape == j.L.shape
                    assert (t.b is None) == (j.b is None)
        if case == "rtn":
            # the same codes: the packed bytes agree but for rounding edges
            lin_t, lin_j = tq.layers[0].o_proj, jq.layers[0].o_proj
            same = (lin_t.packed.numpy() == np.asarray(lin_j.packed)).mean()
            assert same >= 0.99

    def test_batched_matches_serial_and_reference(self):
        jp, tp = _models()
        hs = _hessians(False)
        kw = dict(serving_mode="w4a8", proj_filter=("o_proj",))
        _, tr = TS.compress_model_batched(tp, _cp_full("torch"),
                                          hessians=hs, **kw)
        _, jr = JS.compress_model_batched(jp, _cp_full("jax"), hessians=hs,
                                          **kw)
        _check_reports(jr, tr)

    def test_gate_keeps_dense(self):
        _, tp = _models()
        tq, tr = TS.compress_model(tp, _cp("torch"), error_threshold=0.0,
                                   proj_filter=("up_proj",))
        assert tr.compressed == [] and len(tr.skipped) == CONFIG.num_layers
        assert tr.total_bits == 16 * tr.total_params
        assert all(lp.up_proj is tl.up_proj
                   for lp, tl in zip(tp.layers, tq.layers))
        _, tm = TS.compress_model(tp, _cp("torch"), min_dim=64,
                                  proj_filter=("k_proj", "o_proj"))
        assert sorted(tm.errors) == [f"layers.{i}.o_proj"
                                     for i in range(CONFIG.num_layers)]

    def test_unported_paths_raise(self):
        """The two paths that raised before their modules were ported now
        run (against the reference in tests/test_torch_qat_rotated.py and
        test_torch_allocate.py): servable Hadamard packs RotatedLinears,
        the budget allocates."""
        _, tp = _models()
        q, r = TS.compress_model(tp, _cp("torch"), use_hadamard="servable",
                                 proj_filter=("o_proj",), layer_range=(0, 0))
        assert isinstance(q.layers[0].o_proj, TC.RotatedLinear)
        assert r.compressed == ["layers.0.o_proj"]
        q, r, a = TS.compress_model_with_budget(
            tp, _cp("torch"), B_tot=3.0, proj_filter=("o_proj", "up_proj"),
            layer_range=(1, 1))
        assert sorted(a.bits) == ["layers.1.o_proj", "layers.1.up_proj"]
        assert isinstance(q.layers[1].up_proj, TC.CalderaLinear)


# ---------------------------------------------------------------------------
# utils/checkpoint.py
# ---------------------------------------------------------------------------

def _npz(path):
    with np.load(os.path.join(path, "params.npz")) as z:
        return {k: z[k] for k in z.files}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


class TestCheckpoint:
    def _compressed_jax(self):
        """A reference model with grouped (q_proj), w4a8 (gate_proj,
        down_proj) and e8p (o_proj) linears packed by ``compress_linear`` from
        seeded rank-4 factors, dense projections with biases, and a dense
        head."""
        if "ckpt" not in _MODELS:
            jp, _ = _models()
            rng = np.random.default_rng(2)

            def comp(lin, **kw):
                W = np.asarray(lin.w, np.float32)
                N, K = W.shape
                L = (0.1 * rng.standard_normal((N, 4))).astype(np.float32)
                R = (0.1 * rng.standard_normal((4, K))).astype(np.float32)
                return JC.compress_linear(
                    jnp.asarray(W - L @ R), jnp.asarray(L), jnp.asarray(R),
                    4, global_scale=1.25, bias=lin.b, **kw)
            layers = [lp._replace(
                q_proj=comp(lp.q_proj),
                o_proj=comp(lp.o_proj, mode="w4a8", q_method="e8p"),
                gate_proj=comp(lp.gate_proj, mode="w4a8"),
                down_proj=comp(lp.down_proj, mode="w4a8"))
                for lp in jp.layers]
            _MODELS["ckpt"] = jp._replace(layers=layers)
        return _MODELS["ckpt"]

    def test_both_directions_bit_equal(self, tmp_path):
        jp = self._compressed_jax()
        jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
        JCk.save_params(jdir, jp, CONFIG)
        tp, tconf = TCk.load_params(jdir, device="cpu")
        assert dataclasses.asdict(tconf) == dataclasses.asdict(CONFIG)
        kinds = {type(getattr(tp.layers[0], n)).__name__ + "/"
                 + getattr(getattr(tp.layers[0], n), "q_method", "")
                 for n in TS.PROJ_NAMES}
        assert kinds == {"DenseLinear/", "CalderaLinear/uniform",
                         "CalderaLinear/e8p"}
        # every leaf equal to the reference's bit for bit
        arrays, _ = {}, {}
        _flatten(jp, "", arrays, {})
        got = {}
        _port_leaves(tp, "", got)
        for key, a in arrays.items():
            t = got[key]
            assert str(t.dtype).replace("torch.", "") == str(a.dtype), key
            np.testing.assert_array_equal(_np(t), np.asarray(
                a.astype(np.float32) if a.dtype.name == "bfloat16" else a))
        # and written back by the port, the same file contents
        TCk.save_params(tdir, tp, T_CONFIG)
        ja, ta = _npz(jdir), _npz(tdir)
        assert sorted(ja) == sorted(ta)
        for k in ja:
            assert ja[k].dtype == ta[k].dtype, k
            np.testing.assert_array_equal(ja[k], ta[k])
        assert _manifest(jdir) == _manifest(tdir)
        back, _ = JCk.load_params(tdir)
        arrays2 = {}
        _flatten(back, "", arrays2, {})
        for k, a in arrays.items():
            np.testing.assert_array_equal(np.asarray(arrays2[k]),
                                          np.asarray(a))

    def test_port_model_round_trip(self, tmp_path):
        _, tp = _models()
        tq, _ = TS.compress_model(
            tp, _cp("torch", quant_factory_Q=("e8p", "global")),
            serving_mode="w4a8", serving_quant="e8p",
            proj_filter=("up_proj",))
        TCk.save_params(str(tmp_path), tq, T_CONFIG)
        back, _ = TCk.load_params(str(tmp_path), device="cpu")
        a, b = {}, {}
        _port_leaves(tq, "", a)
        _port_leaves(back, "", b)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


def _port_leaves(obj, prefix, out):
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif isinstance(obj, list):
        for i, o in enumerate(obj):
            _port_leaves(o, f"{prefix}.{i}" if prefix else str(i), out)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            key = f"{prefix}.{f.name}" if prefix else f.name
            _port_leaves(getattr(obj, f.name), key, out)
    elif obj is not None:
        out[prefix] = obj


# ---------------------------------------------------------------------------
# cli.py
# ---------------------------------------------------------------------------

def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class TestCLI:
    def test_pipeline(self, capsys, tmp_path):
        hpath, out = str(tmp_path / "h.npz"), str(tmp_path / "model")
        TCLI.main(["calibrate", "--model", "tiny", "--num-batches", "1",
                   "--window", "16", "--output", hpath, "--device", "cpu"])
        rec = _last_json(capsys)
        assert set(rec) == {"layers", "output"}
        assert rec["layers"] == TINY.num_layers * 7
        TCLI.main(["compress", "--model", "tiny", "--q-bits", "4", "--rank",
                   "4", "--iters", "1", "--lplr-iters", "1", "--hessians",
                   hpath, "--serving-mode", "w4a8", "--output", out,
                   "--device", "cpu"])
        rec = _last_json(capsys)
        assert set(rec) == {"compressed", "skipped", "avg_bits_per_param",
                            "max_rel_error", "seconds"}
        assert rec["compressed"] == TINY.num_layers * 7
        assert rec["avg_bits_per_param"] < 16
        params, config = TCk.load_params(out, device="cpu")
        assert config == T_TINY
        TCLI.main(["eval", "--checkpoint", out, "--synthetic-tokens", "256",
                   "--window", "64", "--device", "cpu"])
        rec = _last_json(capsys)
        assert set(rec) == {"perplexity", "window", "tokens"}
        assert rec["perplexity"] > 1
        for engine in ("slotted", "fast", "paged"):
            TCLI.main(["serve", "--checkpoint", out, "--engine", engine,
                       "--num-requests", "2", "--prompt-len", "4",
                       "--max-new-tokens", "3", "--max-seq-len", "32",
                       "--num-pages", "8", "--page-size", "16",
                       "--device", "cpu"])
            rec = _last_json(capsys)
            assert set(rec) == {"requests", "tokens", "tokens_per_s",
                                "seconds", "path"}
            assert (rec["requests"], rec["tokens"]) == (2, 6)
            assert rec["path"] == ("paged-fused" if engine == "paged"
                                   else engine)

    def test_refusals(self, capsys, tmp_path):
        with pytest.raises(NotImplementedError, match="item 7"):
            TCLI.main(["bench"])
        # a directory that is neither a preset nor an HF checkpoint
        (tmp_path / "config.json").write_text(json.dumps(
            {"vocab_size": 8, "hidden_size": 4, "intermediate_size": 8,
             "num_hidden_layers": 1, "num_attention_heads": 1}))
        with pytest.raises(FileNotFoundError, match="safetensors/bin"):
            TCLI.main(["eval", "--model", str(tmp_path), "--device", "cpu"])
        with pytest.raises(SystemExit, match="w4a8"):
            TCLI.main(["serve", "--model", "tiny", "--engine", "fast",
                       "--device", "cpu"])
        if not torch.cuda.is_available():
            # the default device is the card: no silent CPU run
            with pytest.raises(RuntimeError, match="cuda"):
                TCLI.main(["eval", "--model", "tiny"])
