"""PyTorch port, the two ends of the offline pipeline: ``models/hf_import.py``,
``models/hf_export.py`` (with the port's own safetensors reader and
writer), ``--model <HF directory>`` in ``cli.py``, and ``models/train.py``,
against the JAX reference on the CPU.

Weights cross over as numpy (the reference's ``init_params`` model at
TINY, loaded with ``interop.model_params_from_numpy``). Checkpoint
directories cross both ways and must give equal arrays."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu import cli as JCLI
from ee274_convexcaldera_llm_quantization_tpu.models import hf_export as JE
from ee274_convexcaldera_llm_quantization_tpu.models import hf_import as JI
from ee274_convexcaldera_llm_quantization_tpu.models import llama as JL
from ee274_convexcaldera_llm_quantization_tpu.models import train as JT
from ee274_convexcaldera_llm_quantization_tpu.models.config import TINY
from ee274_convexcaldera_llm_quantization_tpu_torch import cli as TCLI
from ee274_convexcaldera_llm_quantization_tpu_torch.interop import (
    model_params_from_numpy)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    _safetensors)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    hf_export as TE)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    hf_import as TI)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    train as TT)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    TINY as T_TINY)

from test_torch_fused import (  # noqa: F401 (a fixture)
    _flatten, _one_torch_thread)

# TINY with q/k/v biases, so the files carry bias tensors too
CONFIG = dataclasses.replace(TINY, attention_bias=True)
T_CONFIG = dataclasses.replace(T_TINY, attention_bias=True)
# Calibration through the CLI: the same f32 sums in another order (layer
# 0's q/k/v/o inputs: 6e-8 to 7e-8 relative), then activations that pass
# bf16-rounded dots: an f32 ulp of difference upstream rounds a few bf16
# casts the other way, and the later Hessians move by up to 2.6e-4. The
# test shows the cause: one f32 ulp added to every RMSNorm output of the
# port's own calibration moves each Hessian at least as far. Bound: 1e-5
# relative, or that ulp's reach where it is larger.
HESS_RTOL = 1e-5
# Perplexities through the CLI: dense 1e-4, the 4-bit RTN checkpoint 1e-3
# (relative).
PPL_DENSE_RTOL, PPL_RTN_RTOL = 1e-4, 1e-3
# lm_loss: the forward rounds activations to bf16 before each dot, and an
# f32 ulp of another summation order flips some of those casts (the logits
# differ by 5e-4 to 1.7e-3 rel-Frobenius; tests/test_torch_model.py). The
# test shows the scale: the reference's jitted loss against the same loss
# run op by op (jax.disable_jit) differs by up to 1.1e-5 on its batches;
# the port read 1.1e-5 and 1.5e-5 against the jitted loss. Bound 3e-5.
LOSS_RTOL = 3e-5
# train_step x 5 at lr 3e-3: AdamW rounds every op to bf16 in the
# reference's order (the port's bits equal optax's on equal inputs), but
# the gradients come through two autodiffs of bf16-rounded dots (they agree
# within GRAD_RTOL; read 2.5e-4 to 3e-3), and Adam divides each gradient
# element by its own magnitude: an element within the two gradients'
# difference of zero (the test finds every sign that differs there) takes
# a full +-lr step either way. The embedding's rows see few tokens, so it
# has most such elements (read 2.2e-2; every other leaf under 2e-2).
GRAD_RTOL = 1e-2
STEP_LOSS_RTOL, STEP_PARAM_RTOL, STEP_EMBED_RTOL = 2e-3, 2e-2, 3e-2

_MODELS = {}


def _np(t):
    return t.detach().float().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _models():
    """(reference dense params with nonzero biases, the port's copy)."""
    if "dense" not in _MODELS:
        rng = np.random.default_rng(0)
        jp = JL.init_params(jax.random.PRNGKey(0), CONFIG)

        def bias(lin):
            if lin.b is None:
                return lin
            return dataclasses.replace(lin, b=jnp.asarray(
                0.1 * rng.standard_normal(lin.b.shape), jnp.float32))
        jp = jp._replace(layers=[lp._replace(
            q_proj=bias(lp.q_proj), k_proj=bias(lp.k_proj),
            v_proj=bias(lp.v_proj)) for lp in jp.layers])
        arrays, meta = {}, {}
        _flatten(jp, "", arrays, meta)
        _MODELS["dense"] = (jp, model_params_from_numpy(arrays, meta,
                                                        device="cpu"))
    return _MODELS["dense"]


def _leaves_equal(jp, tp):
    """Every array of the reference's params equals the port's, bit for
    bit, and has the same dtype."""
    arrays, meta = {}, {}
    _flatten(jp, "", arrays, meta)
    got = TT.tensor_leaves(tp)
    assert sorted(arrays) == sorted(got)
    for k, a in arrays.items():
        t = got[k]
        assert str(t.dtype).split(".")[-1] == str(a.dtype), k
        assert np.array_equal(_jnp(a), _np(t)), k


# ---------------------------------------------------------------------------
# configs and files
# ---------------------------------------------------------------------------

_HF_CONFIGS = [
    dict(vocab_size=100, hidden_size=64, intermediate_size=96,
         num_hidden_layers=2, num_attention_heads=4),
    dict(model_type="qwen2", vocab_size=100, hidden_size=64,
         intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
         num_key_value_heads=2, rope_theta=1e6, rms_norm_eps=1e-6,
         max_position_embeddings=512, tie_word_embeddings=True),
    dict(model_type="qwen2", attention_bias=False, head_dim=32,
         vocab_size=100, hidden_size=64, intermediate_size=96,
         num_hidden_layers=1, num_attention_heads=4),
    {"text_config": dict(model_type="qwen2", vocab_size=100,
                         hidden_size=64, intermediate_size=96,
                         num_hidden_layers=2, num_attention_heads=2,
                         num_key_value_heads=1)},
]


@pytest.mark.parametrize("hf", _HF_CONFIGS,
                         ids=["llama", "qwen2", "qwen2-nobias", "wrapper"])
def test_config_round_trip(hf):
    j, t = JI.config_from_hf(hf), TI.config_from_hf(hf)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for mt in ("llama", "qwen2"):
        assert TE.config_to_hf(t, mt) == JE.config_to_hf(j, mt)
        assert TI.config_from_hf(TE.config_to_hf(t, mt)) == t


def test_safetensors_dtypes(tmp_path):
    """Every dtype numpy's reader reads crosses both ways with the
    ``safetensors`` package, bit for bit."""
    from safetensors.numpy import load_file, save_file
    rng = np.random.default_rng(1)
    arrays = {name: rng.standard_normal((3, 5)).astype(dt)
              for name, dt in (("f64", np.float64), ("f32", np.float32),
                               ("f16", np.float16))}
    arrays.update({name: rng.integers(-100, 100, (4,)).astype(dt)
                   for name, dt in (("i64", np.int64), ("i32", np.int32),
                                    ("i16", np.int16), ("i8", np.int8),
                                    ("u8", np.uint8), ("u16", np.uint16),
                                    ("u32", np.uint32), ("u64", np.uint64))})
    arrays["bool"] = np.array([True, False, True])
    arrays["scalar"] = np.array(2.5, np.float32)
    ours, theirs = str(tmp_path / "ours.st"), str(tmp_path / "theirs.st")
    _safetensors.save_file(arrays, ours)
    save_file(arrays, theirs)
    back = {k: t.numpy() for k, t in _safetensors.load_file(theirs).items()}
    for got in (load_file(ours), back):
        assert sorted(got) == sorted(arrays)
        for k, a in arrays.items():
            assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
            assert np.array_equal(got[k], a), k


def test_bf16_safetensors(tmp_path):
    """BF16 tensors: ``safetensors``' numpy reader reads them once
    ``ml_dtypes`` is loaded, as it is in every process of the reference
    (JAX loads it), so the reference imports a BF16 snapshot, and the port
    reads the same bits; a float8 tensor neither reads (ROADMAP.md, R12)."""
    from safetensors.torch import save_file
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.standard_normal((6, 4)), dtype=torch.bfloat16)
    d = tmp_path / "ck"
    d.mkdir()
    save_file({"model.embed_tokens.weight": w}, str(d / "model.safetensors"))
    j = JI._load_state_dict(str(d))["model.embed_tokens.weight"]
    t = TI._load_state_dict(str(d))["model.embed_tokens.weight"]
    assert str(j.dtype) == "bfloat16" and t.dtype == torch.bfloat16
    assert np.array_equal(j.view(np.int16), t.view(torch.int16).numpy())
    assert torch.equal(t, w)
    save_file({"f8": w.float().to(torch.float8_e4m3fn)},
              str(d / "model.safetensors"))
    with pytest.raises(AttributeError, match="float8"):
        JI._load_state_dict(str(d))
    with pytest.raises(TypeError, match="R12"):
        TI._load_state_dict(str(d))


def test_export_both_ways(tmp_path):
    """The port's directory read by the reference, the reference's by the
    port: every array equal, configs equal; a compressed linear raises."""
    jp, tp = _models()
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    TE.save_hf_checkpoint(ours, tp, T_CONFIG, model_type="qwen2")
    JE.save_hf_checkpoint(theirs, jp, CONFIG, model_type="qwen2")
    with open(os.path.join(ours, "config.json")) as f, open(
            os.path.join(theirs, "config.json")) as g:
        assert json.load(f) == json.load(g)
    jback, jconfig = JI.load_hf_checkpoint(ours)
    tback, tconfig = TI.load_hf_checkpoint(theirs, device="cpu")
    assert jconfig == CONFIG and tconfig == T_CONFIG
    # the files hold bf16 weights and f32 biases as f32: both reads give
    # the reference's params back
    _leaves_equal(jp, tback)
    _leaves_equal(jback, tp)
    with pytest.raises(ValueError, match="dense"):
        TE.save_hf_checkpoint(str(tmp_path / "x"), dataclasses.replace(
            tp, lm_head=object()), T_CONFIG)


def test_bin_shards_and_prefixes(tmp_path):
    """``pytorch_model*.bin`` shards (bf16 tensors, read as f32) under the
    multimodal wrapper's ``language_model.`` prefixes, and a tied head."""
    jp, tp = _models()
    config = dataclasses.replace(CONFIG, tie_word_embeddings=True)
    sd = {"language_model.model.embed_tokens.weight": tp.embed,
          "language_model.model.norm.weight": tp.final_norm}
    for i, lp in enumerate(tp.layers):
        base = f"language_model.model.layers.{i}"
        sd[f"{base}.input_layernorm.weight"] = lp.attn_norm
        sd[f"{base}.post_attention_layernorm.weight"] = lp.mlp_norm
        for ours, hf in TI._HF_PROJ.items():
            lin = getattr(lp, ours)
            sd[f"{base}.{hf}.weight"] = lin.w
            if lin.b is not None:
                sd[f"{base}.{hf}.bias"] = lin.b
    d = tmp_path / "bin"
    d.mkdir()
    keys = sorted(sd)
    torch.save({k: sd[k] for k in keys[::2]},
               str(d / "pytorch_model-00001-of-00002.bin"))
    torch.save({k: sd[k] for k in keys[1::2]},
               str(d / "pytorch_model-00002-of-00002.bin"))
    hf = {"text_config": JE.config_to_hf(config, "qwen2")}
    with open(d / "config.json", "w") as f:
        json.dump(hf, f)
    jback, jconfig = JI.load_hf_checkpoint(str(d))
    tback, tconfig = TI.load_hf_checkpoint(str(d), device="cpu")
    assert tconfig == dataclasses.replace(T_CONFIG, tie_word_embeddings=True)
    assert jback.lm_head is None and tback.lm_head is None
    _leaves_equal(jback, tback)
    _leaves_equal(jp._replace(lm_head=None), tback)


# ---------------------------------------------------------------------------
# the CLI on an exported directory
# ---------------------------------------------------------------------------

def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _hess(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _ulp_reach(params, rng, n, B, S):
    """Per Hessian, the relative change that one f32 ulp added to every
    RMSNorm output makes in the port's calibration over the CLI's batches
    (``n`` of (B, S) from ``rng``)."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.calibrate import (
        hessian)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
    batches = [rng.integers(0, CONFIG.vocab_size, size=(B, S))
               for _ in range(n)]
    base = hessian.collect_hessians(params, batches, T_CONFIG, diag=True)
    norm = llama.rms_norm
    try:
        llama.rms_norm = lambda x, w, eps: norm(x, w, eps) * (1 + 2.0 ** -23)
        moved = hessian.collect_hessians(params, batches, T_CONFIG, diag=True)
    finally:
        llama.rms_norm = norm
    return {k: float(torch.linalg.norm(moved[k] - base[k])
                     / torch.linalg.norm(base[k])) for k in base}


def test_cli_on_hf_directory(capsys, tmp_path):
    """Both CLIs on one exported directory: calibrate, eval the dense
    model, compress at 4-bit RTN (w4a8) and eval the checkpoint."""
    jp, _ = _models()
    hf = str(tmp_path / "hf")
    JE.save_hf_checkpoint(hf, jp, CONFIG)
    rng = np.random.default_rng(5)
    toks = str(tmp_path / "toks.npy")
    np.save(toks, rng.integers(0, CONFIG.vocab_size, 256))
    out = {}
    for name, main, dev in (("jax", JCLI.main, []),
                            ("torch", TCLI.main, ["--device", "cpu"])):
        h = str(tmp_path / f"h_{name}.npz")
        ck = str(tmp_path / f"ck_{name}")
        main(["calibrate", "--model", hf, "--num-batches", "2",
              "--batch-size", "2", "--window", "32", "--output", h, *dev])
        assert _last_json(capsys)["layers"] == 7 * CONFIG.num_layers
        main(["eval", "--model", hf, "--tokens", toks, "--window", "64",
              *dev])
        dense = _last_json(capsys)["perplexity"]
        main(["compress", "--model", hf, "--hessians", h, "--q-bits", "4",
              "--rank", "8", "--iters", "2", "--lplr-iters", "2",
              "--serving-mode", "w4a8", "--output", ck, *dev])
        rep = _last_json(capsys)
        main(["eval", "--checkpoint", ck, "--tokens", toks, "--window", "64",
              *dev])
        out[name] = (_hess(h), dense, rep, _last_json(capsys)["perplexity"])
    (jh, jd, jr, jq), (th, td, tr, tq) = out["jax"], out["torch"]
    assert sorted(jh) == sorted(th)
    reach = _ulp_reach(_models()[1], np.random.default_rng(0), 2, 2, 32)
    for k in jh:
        rel = np.linalg.norm(th[k] - jh[k]) / np.linalg.norm(jh[k])
        assert rel <= max(HESS_RTOL, reach[k]), (k, rel, reach[k])
    assert abs(td - jd) <= PPL_DENSE_RTOL * jd, (td, jd)
    assert (tr["compressed"], tr["skipped"]) == (jr["compressed"],
                                                 jr["skipped"])
    assert tr["avg_bits_per_param"] == jr["avg_bits_per_param"]
    assert abs(tq - jq) <= PPL_RTN_RTOL * jq, (tq, jq)
    assert tq > td


# ---------------------------------------------------------------------------
# models/train.py
# ---------------------------------------------------------------------------

def _tokens(B=4, S=16, seed=7):
    return np.random.default_rng(seed).integers(
        0, CONFIG.vocab_size, (B, S)).astype(np.int32)


def test_lm_loss():
    jp, tp = _models()
    spread = []
    for seed in (1, 2):
        toks = _tokens(seed=seed)
        j = float(JT.lm_loss(jp, jnp.asarray(toks), CONFIG))
        with jax.disable_jit():
            spread.append(abs(float(JT.lm_loss(jp, jnp.asarray(toks),
                                               CONFIG)) - j) / j)
        t = float(TT.lm_loss(tp, torch.as_tensor(toks), T_CONFIG))
        assert abs(t - j) <= LOSS_RTOL * j, (seed, t, j)
    # the reference is not reproducible to its own summation order either
    assert max(spread) > 1e-6, spread


def test_adamw_matches_optax():
    """One leaf, five updates on equal gradients against optax.adamw's
    jitted update, each step from the reference's params and moments.
    bf16: bit-equal. f32: XLA fuses the moment updates into multiply-adds
    and compiles optax's ``(mu / bc1) / (sqrt(nu / bc2) + eps)`` as
    ``mu / (bc1 * (...))`` (in bf16 the casts between the ops keep every
    rounding), so the moments are held within 2 ulps of their larger term
    and the new value within 1e-4 of the learning rate."""
    import optax
    rng = np.random.default_rng(2)
    p0 = (0.1 * rng.standard_normal(4096)).astype(np.float32)
    grads = [(rng.standard_normal(4096) * 10.0 ** rng.uniform(-4, -1, 4096))
             .astype(np.float32) for _ in range(5)]
    opt = optax.adamw(3e-3)

    @jax.jit
    def step(p, st, g):
        u, st = opt.update(g, st, p)
        return optax.apply_updates(p, u), st

    adamw = TT.make_optimizer(3e-3)

    def t(a, dt):
        return torch.tensor(_jnp(a)).to(dt)

    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jp = jnp.asarray(p0, jdt)
        st = opt.init(jp)
        for k, g in enumerate(grads, 1):
            # one step from the reference's params and moments
            mu, nu = t(st[0].mu, tdt), t(st[0].nu, tdt)
            g = torch.tensor(g)
            tp, tmu, tnu = adamw.step(t(jp, tdt), g.to(tdt), mu, nu, k)
            jp, st = step(jp, st, jnp.asarray(g.numpy(), jdt))
            assert tp.dtype == tdt and tmu.dtype == tdt and tnu.dtype == tdt
            if tdt == torch.bfloat16:
                assert np.array_equal(_jnp(st[0].mu), _np(tmu)), k
                assert np.array_equal(_jnp(st[0].nu), _np(tnu)), k
                assert np.array_equal(_jnp(jp), _np(tp)), k
            else:
                # a multiply-add rounds once where the port rounds its two
                # products and their sum: 2 ulps of the larger term
                for a, b, terms in ((st[0].mu, tmu, (0.1 * g, 0.9 * mu)),
                                    (st[0].nu, tnu, (1e-3 * g * g,
                                                     0.999 * nu))):
                    big = np.maximum(*(np.abs(_np(x)) for x in terms))
                    assert np.all(np.abs(_np(b) - _jnp(a))
                                  <= 2 * np.spacing(big)), k
                # where a moment's two terms cancel, its two roundings part
                # by a larger share of its small value, and the update with
                # it: read up to 6e-6 of lr
                assert np.all(np.abs(_np(tp) - _jnp(jp)) <= 1e-4 * 3e-3), k


def test_train_steps(_one_torch_thread):
    """5 steps at lr 3e-3 from the same params on the same batches; the
    first step's gradients against the reference's."""
    jp, tp = _models()
    toks = _tokens(seed=10)
    jg = jax.grad(lambda p: JT.lm_loss(p, jnp.asarray(toks), CONFIG))(jp)
    xs = {k: t.detach().requires_grad_(True)
          for k, t in TT.tensor_leaves(tp).items()}
    loss = TT.lm_loss(TT.replace_leaves(tp, xs), torch.as_tensor(toks),
                      T_CONFIG)
    tg = dict(zip(xs, torch.autograd.grad(loss, list(xs.values()))))
    arrays, meta = {}, {}
    _flatten(jg, "", arrays, meta)
    for k, a in arrays.items():
        a, b = _jnp(a), _np(tg[k])
        assert np.linalg.norm(b - a) <= GRAD_RTOL * np.linalg.norm(a), k
        flip = np.sign(a) != np.sign(b)
        assert np.all(np.abs(a[flip]) <= np.abs(a - b)[flip]), k

    jp = jax.tree.map(jnp.copy, jp)
    jopt, topt = JT.make_optimizer(3e-3), TT.make_optimizer(3e-3)
    jst, tst = JT.init_train_state(jp, jopt), TT.init_train_state(tp, topt)
    before = {k: t.clone() for k, t in TT.tensor_leaves(tp).items()}
    for i in range(5):
        toks = _tokens(seed=10 + i)
        jp, jst, jl = JT.train_step(jp, jst, jnp.asarray(toks), CONFIG,
                                    jopt)
        tp, tst, tl = TT.train_step(tp, tst, torch.as_tensor(toks),
                                    T_CONFIG, topt)
        assert abs(float(tl) - float(jl)) <= STEP_LOSS_RTOL * float(jl), i
    arrays, meta = {}, {}
    _flatten(jp, "", arrays, meta)
    got = TT.tensor_leaves(tp)
    for k, a in arrays.items():
        ref = _jnp(a)
        assert got[k].dtype == before[k].dtype, k
        rel = np.linalg.norm(_np(got[k]) - ref) / np.linalg.norm(ref)
        assert rel <= (STEP_EMBED_RTOL if k == "embed"
                       else STEP_PARAM_RTOL), (k, rel)
        # every leaf moved (gradient or weight decay)
        assert not torch.equal(got[k], before[k]), k
    # the old params and state are left as they were
    _, tp0 = _models()
    assert all(torch.equal(t, before[k])
               for k, t in TT.tensor_leaves(tp0).items())


def test_frozen_leaves_stay():
    """Integer leaves and the names in ``frozen`` keep their tensors."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        compressed as TC)
    _, tp = _models()
    lin = tp.layers[0].o_proj
    W = lin.w.float()
    clin = TC.compress_linear(W, torch.zeros((128, 4)), torch.zeros((4, 128)),
                              4, mode="w4a8")
    model = dataclasses.replace(tp, layers=[dataclasses.replace(
        tp.layers[0], o_proj=clin)] + tp.layers[1:])
    opt = TT.AdamW(lr=1e-3, frozen=("attn_norm",))
    state = opt.init(model)
    assert "layers.0.o_proj.packed" not in state.mu
    assert "layers.0.attn_norm" not in state.mu
    new, _, loss = TT.train_step(model, state, torch.as_tensor(_tokens()),
                                 T_CONFIG, opt)
    assert torch.isfinite(loss)
    assert new.layers[0].o_proj.packed is clin.packed
    assert new.layers[0].attn_norm is model.layers[0].attn_norm
    assert not torch.equal(new.layers[0].mlp_norm, model.layers[0].mlp_norm)


# ---------------------------------------------------------------------------
# the whole port pipeline
# ---------------------------------------------------------------------------

def test_port_pipeline(capsys, tmp_path, _one_torch_thread):
    """Train a few steps, export, then calibrate, compress (4-bit, w4a8)
    and eval through the port's CLI, all on the CPU."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
    params = llama.init_params(0, T_TINY, device="cpu")
    opt = TT.make_optimizer(3e-3)
    state = TT.init_train_state(params, opt)
    toks = _tokens(B=4, S=32, seed=3)
    losses = []
    for _ in range(6):
        params, state, loss = TT.train_step(
            params, state, torch.as_tensor(toks), T_TINY, opt)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    hf = str(tmp_path / "hf")
    TE.save_hf_checkpoint(hf, params, T_TINY)
    stream = str(tmp_path / "s.npy")
    np.save(stream, np.tile(toks.reshape(-1), 2))
    h = str(tmp_path / "h.npz")
    TCLI.main(["calibrate", "--model", hf, "--num-batches", "1",
               "--window", "32", "--output", h, "--device", "cpu"])
    TCLI.main(["eval", "--model", hf, "--tokens", stream, "--window", "64",
               "--device", "cpu"])
    dense = _last_json(capsys)["perplexity"]
    ck = str(tmp_path / "ck")
    TCLI.main(["compress", "--model", hf, "--hessians", h, "--q-bits", "4",
               "--rank", "8", "--iters", "1", "--lplr-iters", "1",
               "--serving-mode", "w4a8", "--output", ck, "--device", "cpu"])
    assert _last_json(capsys)["compressed"] == 7 * T_TINY.num_layers
    TCLI.main(["eval", "--checkpoint", ck, "--tokens", stream, "--window",
               "64", "--device", "cpu"])
    ppl = _last_json(capsys)["perplexity"]
    assert np.isfinite(dense) and dense > 1 and np.isfinite(ppl)
