"""PyTorch port, QAT and the servable Hadamard basis: ``models/
compressed.py``'s ``ste_quantize``, ``QATLinear`` and ``RotatedLinear``,
``models/qat.py``, ``models/surgery.py``'s ``compress_linear_rotated`` and
``use_hadamard="servable"``, and ``utils/profiling.py``, against the JAX
reference on the CPU."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.models import compressed as JC
from ee274_convexcaldera_llm_quantization_tpu.models import qat as JQ
from ee274_convexcaldera_llm_quantization_tpu.models import surgery as JS
from ee274_convexcaldera_llm_quantization_tpu.utils import profiling as JP
from ee274_convexcaldera_llm_quantization_tpu_torch.interop import (
    model_params_from_numpy)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    compressed as TC)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import qat as TQ
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    surgery as TS)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    train as TT)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as TK
from ee274_convexcaldera_llm_quantization_tpu_torch.utils import (
    profiling as TP)

from test_torch_fused import (  # noqa: F401 (a fixture)
    _flatten, _one_torch_thread)
from test_torch_hf_train import (CONFIG, STEP_LOSS_RTOL, STEP_PARAM_RTOL,
                                 T_CONFIG, _jnp, _models, _np, _tokens)
from test_torch_surgery import RTN_ATOL, _check_reports, _cp, _hessians

# f32 dots of the same operands in another summation order (the QAT
# forward, the rotated linear's FWHTs around its kernel's plain version)
DOT_RTOL = 1e-5


def _rng_linear(seed, N=128, K=256, rank=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, K)).astype(np.float32),
            (0.1 * rng.standard_normal((N, rank))).astype(np.float32),
            (0.1 * rng.standard_normal((rank, K))).astype(np.float32),
            rng.standard_normal(N).astype(np.float32))


# ---------------------------------------------------------------------------
# ste_quantize and QATLinear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,group", [(2, None), (4, None), (8, None),
                                        (4, 64), (2, 32)])
def test_ste_quantize(bits, group):
    W = _rng_linear(bits)[0]
    j = np.asarray(JC.ste_quantize(jnp.asarray(W), bits, group))
    Wt = torch.tensor(W, requires_grad=True)
    t = TC.ste_quantize(Wt, bits, group)
    assert np.array_equal(t.detach().numpy(), j)
    G = torch.randn(W.shape, generator=torch.Generator().manual_seed(1))
    (t * G).sum().backward()
    assert torch.equal(Wt.grad, G)          # straight through
    if group is not None:
        with pytest.raises(ValueError, match="divisible"):
            TC.ste_quantize(torch.tensor(W[:, :group + 1]), bits, group)


def _pair(seed, bits, mode):
    """A CalderaLinear packed by both packages from the same (Q, L, R)."""
    W, L, R, b = _rng_linear(seed)
    j = JC.compress_linear(jnp.asarray(W), jnp.asarray(L), jnp.asarray(R),
                           bits, global_scale=0.7, bias=jnp.asarray(b),
                           mode=mode)
    t = TC.compress_linear(torch.tensor(W), torch.tensor(L), torch.tensor(R),
                           bits, global_scale=0.7, bias=torch.tensor(b),
                           mode=mode)
    assert np.array_equal(np.asarray(j.packed), t.packed.numpy())
    return j, t


@pytest.mark.parametrize("bits,mode", [(4, "w4a8"), (2, "w4a8"),
                                       (8, "w4a8"), (4, "grouped"),
                                       (2, "grouped")])
def test_prepare_finalize(bits, mode):
    """prepare: the same f32 latent and factors; finalize: the codes and
    scales the linear came with (and the reference's), lossless."""
    j, t = _pair(bits, bits, mode)
    jq, tq = JQ.prepare_qat_linear(j), TQ.prepare_qat_linear(t)
    # equal codes; the reference's jitted packers compute absmax / maxq in
    # another order (tests/test_torch_compress_quant.py), so scales, and
    # the latent with them, sit an ulp apart
    assert np.allclose(np.asarray(j.scales), t.scales.numpy(), rtol=2e-7,
                       atol=0)
    assert np.allclose(np.asarray(jq.Wq), tq.Wq.numpy(), rtol=2e-7, atol=0)
    assert np.array_equal(np.asarray(jq.L), tq.L.numpy())
    assert (tq.num_bits, tq.group_size, tq.mode) == (jq.num_bits,
                                                     jq.group_size, jq.mode)
    assert tq.global_scale.dtype == torch.float32
    jf, tf = JQ.finalize_qat_linear(jq), TQ.finalize_qat_linear(tq)
    for lin in (tf, jf):
        assert np.array_equal(np.asarray(lin.packed), t.packed.numpy())
    assert torch.equal(tf.scales, t.scales)
    # the fake-quant forward is the f32 dequantized weight
    maxq = 2 ** (bits - 1) - 1
    q = TK.unpack_codes(t.packed, bits).float() - maxq
    Wq = q * t.scales.repeat_interleave(q.shape[1] // t.scales.shape[1], 1)
    want = t.global_scale * (Wq + tq.L @ tq.R)
    assert torch.allclose(tq.effective_weight().detach(), want, rtol=1e-6,
                          atol=1e-7)


@pytest.mark.parametrize("mode", ["w4a8", "grouped"])
def test_qat_linear_forward(mode):
    j, t = _pair(3, 4, mode)
    jq, tq = JQ.prepare_qat_linear(j), TQ.prepare_qat_linear(t)
    x = np.random.default_rng(4).standard_normal((5, 256)).astype(
        np.float32)
    jy = np.asarray(JC.apply_linear(jq, jnp.asarray(x)))
    ty = TC.apply_linear(tq, torch.tensor(x)).detach().numpy()
    assert np.linalg.norm(ty - jy) <= DOT_RTOL * np.linalg.norm(jy)
    assert np.allclose(tq.materialize().detach().numpy(),
                       np.asarray(jq.materialize()), rtol=0, atol=1e-6)
    # global_scale sits outside the gradient, the latent inside it
    tq = dataclasses.replace(
        tq, Wq=tq.Wq.clone().requires_grad_(True),
        global_scale=tq.global_scale.clone().requires_grad_(True))
    y = TC.apply_linear(tq, torch.tensor(x)).sum()
    gW, gs = torch.autograd.grad(y, [tq.Wq, tq.global_scale],
                                 allow_unused=True)
    assert gs is None and gW is not None and gW.abs().sum() > 0


_COMPRESSED = {}


def _compressed_models():
    """TINY compressed by the reference (4-bit w4a8, rank 8), on both
    sides (the port's copy is rebuilt on every call: tests may train
    it)."""
    if "jax" not in _COMPRESSED:
        jp, _ = _models()
        jq, _ = JS.compress_model(jp, _cp("jax", Q_bits=4, iters=1),
                                  serving_mode="w4a8")
        arrays, meta = {}, {}
        _flatten(jq, "", arrays, meta)
        _COMPRESSED.update(jax=jq, arrays=arrays, meta=meta)
    return _COMPRESSED["jax"], model_params_from_numpy(
        _COMPRESSED["arrays"], _COMPRESSED["meta"], device="cpu")


def test_qat_finetune(_one_torch_thread):
    """3 steps of ``qat_finetune`` at lr 1e-3 from the same compressed
    model: each loss within the train test's bound, the finalized model's
    weights within its param bound, every global_scale unchanged, and the
    caller's params untouched."""
    jq, tq = _compressed_models()
    toks = _tokens(seed=21)
    before = {k: v.clone() for k, v in TT.tensor_leaves(tq).items()}
    jf, jl = JQ.qat_finetune(jq, jnp.asarray(toks), CONFIG, steps=3,
                             lr=1e-3)
    tf, tl = TQ.qat_finetune(tq, torch.as_tensor(toks), T_CONFIG, steps=3,
                             lr=1e-3)
    assert len(tl) == 3 and tl[-1] < tl[0]
    for a, b in zip(jl, tl):
        assert abs(b - a) <= STEP_LOSS_RTOL * a, (jl, tl)
    assert all(torch.equal(v, before[k])
               for k, v in TT.tensor_leaves(tq).items())
    for jlp, tlp, olp in zip(jf.layers, tf.layers, tq.layers):
        for proj in TS.PROJ_NAMES:
            a, b, o = (getattr(jlp, proj), getattr(tlp, proj),
                       getattr(olp, proj))
            assert isinstance(b, TC.CalderaLinear) and b.mode == "w4a8"
            assert torch.equal(b.global_scale, o.global_scale)
            assert float(np.asarray(a.global_scale)) == float(b.global_scale)
            ref = np.asarray(a.materialize())
            rel = np.linalg.norm(b.materialize().numpy() - ref) / (
                np.linalg.norm(ref))
            assert rel <= STEP_PARAM_RTOL, (proj, rel)
    # the dense leaves trained too
    assert not torch.equal(tf.embed, tq.embed)


def test_qat_optimizer_freezes_global_scale():
    _, tq = _compressed_models()
    qp = TQ.prepare_qat_model(tq)
    opt = TQ.make_qat_optimizer()
    state = opt.init(qp)
    assert opt.lr == 1e-5 and opt.weight_decay == 1e-4
    names = set(state.mu)
    assert not any(k.endswith("global_scale") for k in names)
    assert "layers.0.q_proj.Wq" in names and "embed" in names
    qp2, _, _ = TT.train_step(qp, state, torch.as_tensor(_tokens()),
                              T_CONFIG, opt)
    gs = qp.layers[0].q_proj.global_scale
    assert qp2.layers[0].q_proj.global_scale is gs
    assert not torch.equal(qp2.layers[0].q_proj.Wq, qp.layers[0].q_proj.Wq)


# ---------------------------------------------------------------------------
# RotatedLinear and the servable Hadamard basis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,mode", [((128, 128), "w4a8"),
                                        ((128, 96), "w4a8"),
                                        ((96, 128), "grouped")])
def test_compress_linear_rotated(shape, mode):
    """Each power-of-two side rotated; the error in the original basis and
    the packed inner linear equal; the rotated forward against the
    reference's."""
    rng = np.random.default_rng(7)
    W = rng.standard_normal(shape).astype(np.float32)
    h = rng.uniform(0.5, 2.0, shape[1]).astype(np.float32)
    b = rng.standard_normal(shape[0]).astype(np.float32)
    jl, je = JS.compress_linear_rotated(_cp("jax", Q_bits=4), jnp.asarray(W),
                                        H=jnp.asarray(h),
                                        serving_mode=mode, bias=jnp.asarray(b))
    tl, te = TS.compress_linear_rotated(_cp("torch", Q_bits=4),
                                        torch.tensor(W), H=torch.tensor(h),
                                        serving_mode=mode,
                                        bias=torch.tensor(b))
    assert (tl.rot_in, tl.rot_out) == (jl.rot_in, jl.rot_out)
    assert (tl.rot_in, tl.rot_out) == (shape[1] == 128, shape[0] == 128)
    assert abs(te - je) <= RTN_ATOL
    assert np.array_equal(np.asarray(jl.inner.packed), tl.inner.packed.numpy())
    x = rng.standard_normal((6, shape[1])).astype(np.float32)
    jy = np.asarray(JC.apply_linear(jl, jnp.asarray(x)))
    ty = TC.apply_linear(tl, torch.tensor(x)).numpy()
    # the FWHTs are the same butterflies; the difference is the inner
    # linear's own (w4a8: int8 activation codes on a rounding edge, R6;
    # grouped: bf16 casts), which the rotation carries with its norm
    u = torch.tensor(x)
    if tl.rot_in:
        u = TK.fwht(u) / torch.sqrt(torch.tensor(float(shape[1])))
    inner = np.linalg.norm(
        TC.apply_linear(tl.inner, u).numpy()
        - np.asarray(JC.apply_linear(jl.inner, jnp.asarray(u.numpy()))))
    assert np.linalg.norm(ty - jy) <= inner + DOT_RTOL * np.linalg.norm(jy)
    # the forward is the rotated weight's product
    dense = x @ tl.materialize().numpy().T + b
    assert np.linalg.norm(ty - dense) <= 2e-2 * np.linalg.norm(dense)


def test_servable_hadamard_model(_one_torch_thread):
    """``compress_model(use_hadamard="servable")`` at TINY, layer 1, with
    Hessians: the same report and RotatedLinears, and the model's logits."""
    from ee274_convexcaldera_llm_quantization_tpu.models import llama as JL
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
    jp, tp = _models()
    kw = dict(hessians=_hessians(True), layer_range=(1, 1),
              serving_mode="w4a8", use_hadamard="servable")
    jq, jr = JS.compress_model(jp, _cp("jax", Q_bits=4, iters=1), **kw)
    tq, tr = TS.compress_model(tp, _cp("torch", Q_bits=4, iters=1), **kw)
    _check_reports(jr, tr)
    rot = [getattr(tq.layers[1], p) for p in TS.PROJ_NAMES]
    assert all(isinstance(r, TC.RotatedLinear) for r in rot)
    assert [(r.rot_in, r.rot_out) for r in rot] == [
        (getattr(jq.layers[1], p).rot_in, getattr(jq.layers[1], p).rot_out)
        for p in TS.PROJ_NAMES]
    toks = _tokens(B=2, S=8, seed=9)
    jl = np.asarray(JL.forward(jq, jnp.asarray(toks), CONFIG))
    tl = llama.forward(tq, torch.as_tensor(toks), T_CONFIG).numpy()
    # the int8 activations of the rotated w4a8 linears can round a code the
    # other way (R6); the logits are held as the model tests hold them
    assert np.linalg.norm(tl - jl) <= 1e-2 * np.linalg.norm(jl)


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------

def test_phase_timer_and_event_log(tmp_path):
    jt, tt = JP.PhaseTimer(), TP.PhaseTimer()
    for timer in (jt, tt):
        with timer.phase("calibrate"):
            pass
        with timer.phase("compress"):
            pass
        with timer.phase("calibrate"):
            pass
    assert list(tt.summary()) == list(jt.summary()) == ["calibrate",
                                                         "compress"]
    assert json.loads(str(tt)) == tt.summary()
    with pytest.raises(KeyError):
        with tt.phase("failed"):
            raise KeyError("x")
    assert "failed" in tt.summary()
    jlog, tlog = JP.EventLog(), TP.EventLog()
    for log in (jlog, tlog):
        log.log("outlier", layer=3, count=7)
        log.log("gate", name="layers.0.q_proj", kept=True)
        log.log("outlier", layer=4, count=1)
    strip = [{k: v for k, v in e.items() if k != "t"}
             for e in tlog.events]
    assert strip == [{k: v for k, v in e.items() if k != "t"}
                     for e in jlog.events]
    assert [e["layer"] for e in tlog.of_kind("outlier")] == [3, 4]
    path = str(tmp_path / "ev.jsonl")
    tlog.dump(path)
    with open(path) as f:
        assert [json.loads(line)["kind"] for line in f] == [
            "outlier", "gate", "outlier"]


def test_device_trace(tmp_path):
    with TP.device_trace(None):
        pass
    with TP.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_prepare_copies_leaves(_one_torch_thread):
    """The QAT params hold copies of the dense leaves."""
    jq, tq = _compressed_models()
    j = JQ.prepare_qat_model(jq)
    t = TQ.prepare_qat_model(tq)
    assert np.array_equal(_jnp(j.embed), _np(t.embed))
    assert t.embed is not tq.embed and torch.equal(t.embed, tq.embed)
