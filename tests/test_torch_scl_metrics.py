"""PyTorch port, the quality end of the pipeline: ``quant/scl.py`` (the SCL
baselines), ``evalm/metrics.py`` and ``evalm/accuracy.py``, against the JAX
reference on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.evalm import accuracy as JA
from ee274_convexcaldera_llm_quantization_tpu.evalm import metrics as JMe
from ee274_convexcaldera_llm_quantization_tpu.quant import scl as JQ
from ee274_convexcaldera_llm_quantization_tpu_torch.evalm import (
    accuracy as TA)
from ee274_convexcaldera_llm_quantization_tpu_torch.evalm import (
    metrics as TMe)
from ee274_convexcaldera_llm_quantization_tpu_torch.quant import scl as TQ

from test_torch_fused import _one_torch_thread  # noqa: F401 (a fixture)
from test_torch_hf_train import CONFIG, T_CONFIG, _models

# Lloyd-Max and K-means from the same first centroids: the cell sums are
# one-hot f32 matmuls in the reference and f64 sums here, so the codebooks
# agree to f32 rounding (held to 1e-5 relative); an index may differ only
# where the reference's two distances tie to 1e-5.
CB_RTOL, TIE_RTOL = 1e-5, 1e-5


def _data(seed=0, shape=(128, 256)):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_scalar_uniform(bits):
    x = _data(bits)
    j = [np.asarray(a) for a in JQ.scalar_quantize_uniform(jnp.asarray(x),
                                                           bits)]
    t = [a.numpy() for a in TQ.scalar_quantize_uniform(torch.tensor(x),
                                                       bits)]
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and np.array_equal(a, b), bits
    jr = JQ.scl_quantize(jnp.asarray(x), JQ.SCLQuantizationParams(
        num_bits=bits, distortion_metric="mae"))
    tr = TQ.scl_quantize(torch.tensor(x), TQ.SCLQuantizationParams(
        num_bits=bits, distortion_metric="mae"))
    assert (tr.rate, tr.compression_ratio, tr.num_codebook_entries,
            tr.method) == (jr.rate, jr.compression_ratio,
                           jr.num_codebook_entries, jr.method)
    assert tr.distortion == pytest.approx(jr.distortion, rel=1e-6)


def _tie_ok(points, centroids, a, b):
    """Indices ``a`` (reference) and ``b`` differ only on near ties."""
    d = ((points[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    rows = np.nonzero(a != b)[0]
    da, db = d[rows, a[rows]], d[rows, b[rows]]
    return bool(np.all(np.abs(da - db) <= TIE_RTOL * np.maximum(da, 1e-30)))


@pytest.mark.parametrize("bits", [2, 4])
def test_lloyd_max(bits):
    x = _data(10 + bits)
    flat = x.reshape(-1)
    L = 2 ** bits
    q, cb, idx, dist = (np.asarray(a) for a in JQ.lloyd_max(
        jnp.asarray(x), bits, 100, 1e-6))
    # the reference's first codebook, as its jitted function makes it
    cb0 = np.asarray(jax.jit(lambda f: jnp.linspace(
        jnp.min(f), jnp.max(f), L))(jnp.asarray(flat)))
    tcb0 = TQ._linspace(torch.tensor(flat).min(), torch.tensor(flat).max(),
                        L)
    assert np.allclose(tcb0.numpy(), cb0, rtol=1e-6, atol=0)
    tcb, tdist = TQ.lloyd_max_fixed_point(torch.tensor(flat),
                                          torch.tensor(cb0), 100, 1e-6)
    assert np.allclose(tcb.numpy(), cb, rtol=CB_RTOL, atol=0)
    assert float(tdist) == pytest.approx(float(dist), rel=CB_RTOL)
    tq, tcb2, tidx, tdist2 = TQ.lloyd_max(torch.tensor(x), bits, 100, 1e-6)
    assert np.allclose(tcb2.numpy(), cb, rtol=CB_RTOL, atol=0)
    assert tidx.shape == x.shape and tq.shape == x.shape
    assert _tie_ok(flat[:, None], cb[:, None], idx.reshape(-1),
                   tidx.numpy().reshape(-1))
    # quantized values are the codebook's
    assert np.array_equal(tq.numpy(), tcb2.numpy()[tidx.numpy()])


@pytest.mark.parametrize("bits,dim", [(2, 2), (4, 2), (3, 3)])
def test_kmeans(bits, dim):
    x = _data(20 + bits, shape=(64, 100))
    q, cb, idx, dist = (np.asarray(a) for a in JQ.kmeans_vq(
        jnp.asarray(x), bits, dim, 100, 1e-6, 42))
    vecs = TQ._vectors(torch.tensor(x), dim)
    k = min(2 ** bits, vecs.shape[0])
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(42),
                                        vecs.shape[0], (k,), replace=False))
    tcb, tdist = TQ.kmeans_fixed_point(vecs, vecs[torch.tensor(init)], 100,
                                       1e-6)
    assert np.allclose(tcb.numpy(), cb, rtol=CB_RTOL, atol=1e-7)
    assert float(tdist) == pytest.approx(float(dist), rel=CB_RTOL)
    tidx = TQ._assign_vectors(vecs)(tcb).numpy()
    assert _tie_ok(vecs.numpy(), cb, idx, tidx)
    # the port's own first centroids (torch.randperm) give another local
    # optimum of the same quality
    tq, tcb2, tidx2, tdist2 = TQ.kmeans_vq(torch.tensor(x), bits, dim, 100,
                                           1e-6, 42)
    assert tq.shape == x.shape and tcb2.shape == (k, dim)
    assert float(tdist2) == pytest.approx(float(dist), rel=0.1)
    r = TQ.scl_quantize(torch.tensor(x), TQ.SCLQuantizationParams(
        num_bits=bits, method="vector", vector_dim=dim))
    assert r.rate == bits / dim and r.num_codebook_entries == k


def test_scl_paths_and_params():
    """``apply_scl_baseline_to_params``: the reference's path names, every
    2-D leaf (embedding and head too), the scalar baseline's values equal,
    and a ``layer_names`` filter."""
    jp, tp = _models()
    p = dict(num_bits=2)
    jn, jres = JQ.apply_scl_baseline_to_params(
        jp, scl_params=JQ.SCLQuantizationParams(**p))
    tn, tres = TQ.apply_scl_baseline_to_params(
        tp, scl_params=TQ.SCLQuantizationParams(**p))
    assert list(tres) == list(jres)
    assert ".layers/0/.q_proj/.w" in tres and ".embed" in tres
    for name in jres:
        a, b = jres[name], tres[name]
        assert np.array_equal(np.asarray(a.quantized), b.quantized.numpy())
        # an f32 mean over up to 32768 squares, in another order
        assert b.distortion == pytest.approx(a.distortion, rel=1e-5)
    assert tn.layers[0].q_proj.w.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(jn.layers[1].down_proj.w.astype(
        jnp.float32)), tn.layers[1].down_proj.w.float().numpy())
    assert tn.layers[0].attn_norm is tp.layers[0].attn_norm
    names = [".layers/1/.o_proj/.w", ".lm_head/.w"]
    tn2, tres2 = TQ.apply_scl_baseline_to_params(tp, layer_names=names)
    _, jres2 = JQ.apply_scl_baseline_to_params(jp, layer_names=names)
    assert list(tres2) == list(jres2) == names
    assert tn2.layers[0].o_proj.w is tp.layers[0].o_proj.w


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics():
    rng = np.random.default_rng(3)
    W = rng.standard_normal((48, 80))
    W_hat = W + 0.01 * rng.standard_normal(W.shape)
    for args in (((48, 80), 2.0), ((48, 80), 3.0, 16, 16.0, 16.0, 64),
                 ((4096, 11008), 4.0, 128)):
        assert TMe.compute_bits_per_parameter(*args) == (
            JMe.compute_bits_per_parameter(*args))
    kw = dict(shape=(48, 80), avg_bits=2.0, rank=8, W=W, W_hat=W_hat,
              acc_original=0.8, acc_compressed=0.75, ppl_original=5.0,
              ppl_compressed=5.6, duality_gap=1e-7, effective_rank=8.0,
              block_size=16)
    j = dataclasses.asdict(JMe.evaluate_compression(**kw))
    t = dataclasses.asdict(TMe.evaluate_compression(
        **dict(kw, W=torch.tensor(W), W_hat=torch.tensor(W_hat))))
    assert t.pop("relative_error") == pytest.approx(j.pop("relative_error"),
                                                    rel=1e-12)
    assert t == j
    assert dataclasses.asdict(TMe.evaluate_compression((8, 8), 4.0)) == (
        dataclasses.asdict(JMe.evaluate_compression((8, 8), 4.0)))
    assert np.allclose(TMe.compute_singular_values(torch.tensor(W)).numpy(),
                       JMe.compute_singular_values(W), rtol=1e-12)
    assert TMe.compute_compression_ratio(2.5) == (
        JMe.compute_compression_ratio(2.5))
    assert TMe.compute_model_size_mb(10 ** 6, 2.5) == (
        JMe.compute_model_size_mb(10 ** 6, 2.5))


def test_plots(tmp_path, monkeypatch):
    """The plots write their files; without matplotlib (as on the card's
    host) they raise ImportError."""
    paths = [str(tmp_path / f"{i}.png") for i in range(4)]
    TMe.plot_bit_allocation_heatmap(np.array([[2, 4], [8, 4]]), ["a", "b"],
                                    save_path=paths[0])
    TMe.plot_accuracy_vs_bits([2, 4], [0.5, 0.7], ["x", "y"],
                              save_path=paths[1])
    TMe.plot_loss_vs_rank([8, 16], [1.0, 0.5], save_path=paths[2])
    TMe.plot_singular_value_spectra({"w": torch.tensor([3.0, 1.0])},
                                    save_path=paths[3])
    assert all((tmp_path / f"{i}.png").stat().st_size > 0 for i in range(4))
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(ImportError):
        TMe.plot_loss_vs_rank([8], [1.0])


# ---------------------------------------------------------------------------
# accuracy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text,want", [
    ("Yes, there is a dog.", "yes"), ("no.", "no"), ("NO way", "no"),
    ("I think yes or no", "yes"), ("nothing yesterday", None), ("", None),
    ("the answer: No", "no")])
def test_extract_yes_no(text, want):
    assert TA.extract_yes_no(text) == JA.extract_yes_no(text) == want


def _detok(ids):
    """Ids to words: even ids say yes, ids divisible by 3 say no."""
    return " ".join("yes" if i % 2 == 0 else "no" if i % 3 == 0 else "w%d" % i
                    for i in ids)


def test_accuracy(_one_torch_thread):
    """Greedy generation at TINY: the same answers per example."""
    jp, tp = _models()
    rng = np.random.default_rng(6)
    examples = [(rng.integers(0, CONFIG.vocab_size, 6),
                 "yes" if i % 2 else "no") for i in range(4)]
    j = JA.evaluate_yes_no_accuracy(
        jp, [JA.QAExample(p, label) for p, label in examples], CONFIG,
        _detok, max_new_tokens=3)
    seen = []
    t = TA.evaluate_yes_no_accuracy(
        tp, [TA.QAExample(p, label) for p, label in examples], T_CONFIG,
        _detok, max_new_tokens=3, device="cpu",
        progress=lambda i, acc: seen.append(i))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert seen == list(range(4))


def test_accuracy_errors(monkeypatch):
    """A decoder's error counts the example as failed; an error raised
    inside generation (a kernel or CUDA failure) propagates (R13)."""
    _, tp = _models()
    ex = [TA.QAExample(np.arange(4), "yes")]

    def bad_detok(ids):
        raise KeyError(ids[0])
    r = TA.evaluate_yes_no_accuracy(tp, ex, T_CONFIG, bad_detok,
                                    max_new_tokens=2, device="cpu")
    assert (r.num_failed, r.num_correct, r.per_example) == (
        1, 0, [(0, None, "yes")])

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(TA.llama, "generate_greedy", broken)
    with pytest.raises(RuntimeError, match="illegal memory"):
        TA.evaluate_yes_no_accuracy(tp, ex, T_CONFIG, _detok,
                                    max_new_tokens=2, device="cpu")

    def failing_detok(ids):
        raise RuntimeError("not a decoding error")
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="not a decoding"):
        TA.evaluate_yes_no_accuracy(tp, ex, T_CONFIG, failing_detok,
                                    max_new_tokens=2, device="cpu")
