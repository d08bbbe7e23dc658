"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and decode steps through the kernels against the same steps
through the plain versions.

Every test needs an NVIDIA GPU and skips without one. The file imports no
JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused, llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    TINY_MHA)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(y, ref):
    # exact i32 sums on both sides; the f32 epilogue keeps the same order
    torch.testing.assert_close(y.cpu(), ref.cpu(), rtol=1e-6,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 8, 33])
def test_w4a8_kernel_matches_plain(dev, bits, M):
    rng = np.random.default_rng(400 + bits + M)
    f = 8 // bits
    x = torch.from_numpy(rng.normal(size=(M, 512)).astype(np.float32))
    high = 255 if bits == 8 else 256
    packed = torch.from_numpy(
        rng.integers(0, high, size=(3, 200, 512 // f), dtype=np.uint8))
    scales = torch.from_numpy(
        rng.uniform(0.001, 0.02, size=(3, 200, 1)).astype(np.float32))
    ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 2, bits)
    y = K.quantized_matmul_w4a8_stacked(x.to(dev), packed.to(dev),
                                        scales.to(dev), 2, bits)
    _close(y, ref)


@pytest.mark.parametrize("M", [1, 8, 33])
def test_int8_kernel_matches_plain(dev, M):
    rng = np.random.default_rng(500 + M)
    x = torch.from_numpy(rng.normal(size=(M, 256)).astype(np.float32))
    w8 = torch.from_numpy(rng.integers(-127, 128, size=(300, 256),
                                       dtype=np.int8))
    s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(300, 1))
                         .astype(np.float32))
    _close(K.int8_matmul(x.to(dev), w8.to(dev), s.to(dev)),
           K.int8_matmul_plain(x, w8, s))


@pytest.mark.parametrize("dots", ["i8", "f32"])
@pytest.mark.parametrize("G,D", [(1, 128), (2, 32), (4, 128)])
def test_attention_kernel_matches_plain(dev, dots, G, D):
    rng = np.random.default_rng(600 + G + D)
    L, B, KVH, T = 2, 6, 2, 64
    pos = torch.tensor([0, 1, 32, 33, 50, 64], dtype=torch.int32)
    t = dict(
        q=rng.normal(size=(B, KVH, G, D)).astype(np.float32),
        k=rng.integers(-127, 128, size=(L, B, KVH, T, D), dtype=np.int8),
        v=rng.integers(-127, 128, size=(L, B, KVH, T, D), dtype=np.int8),
        ks=rng.uniform(0.001, 0.02, size=(L, B, KVH, T)).astype(np.float32),
        vs=rng.uniform(0.001, 0.02, size=(L, B, KVH, T)).astype(np.float32),
        kn=rng.normal(size=(B, KVH, D)).astype(np.float32),
        vn=rng.normal(size=(B, KVH, D)).astype(np.float32))
    t = {n: torch.from_numpy(a) for n, a in t.items()}
    args = [t[n] for n in ("q", "k", "v", "ks", "vs", "kn", "vn")]
    ref = AT.flash_decode_q8_staged_plain(*args, 1, pos, block_t=32,
                                          dots=dots)
    out = AT.flash_decode_q8_staged(*[a.to(dev) for a in args], 1,
                                    pos.to(dev), block_t=32, dots=dots).cpu()
    if dots == "f32":
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-6)
    else:
        # expf and sum order can flip one int8 probability code
        rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        assert rel <= 1e-4, rel


def test_decode_step_kernels_match_plain_on_card(dev, monkeypatch):
    # Against the plain versions on the card, the PyTorch glue around the
    # kernels is the same on both sides; against the CPU it is not, and an
    # f32 ulp of the glue can flip one int8 code (ROADMAP R6).
    config = dataclasses.replace(TINY_MHA, num_layers=2)
    params = fused.quantize_factors_int8_fused(fused.fuse_stacked(
        bench_params.build_compressed_llama_params(config, rank=16, seed=0,
                                                   device=dev)))
    B, T = 4, 16
    counters = (K.quantized_matmul_w4a8_stacked, AT.flash_decode_q8_staged,
                K.int8_matmul)
    before = [fn.launches for fn in counters]
    ckern = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    kern_logits = []
    tokens = torch.tensor([1, 2, 3, 4], device=dev)
    for step in range(3):
        pos = torch.full((B,), step, dtype=torch.int32, device=dev)
        logits, ckern = fused.decode_step_fused(params, tokens, pos, ckern,
                                                config, staged_kv="uniform",
                                                attn_dots="i8")
        kern_logits.append(logits)
        tokens = logits.argmax(-1)
    assert ([fn.launches - b for fn, b in zip(counters, before)]
            == [3 * 4 * 2, 3 * 2, 3])

    monkeypatch.setattr(K, "quantized_matmul_w4a8_stacked",
                        K.quantized_matmul_w4a8_stacked_plain)
    monkeypatch.setattr(K, "int8_matmul", K.int8_matmul_plain)
    monkeypatch.setattr(AT, "flash_decode_q8_staged",
                        AT.flash_decode_q8_staged_plain)
    cplain = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
    tokens = torch.tensor([1, 2, 3, 4], device=dev)
    for step in range(3):
        pos = torch.full((B,), step, dtype=torch.int32, device=dev)
        logits, cplain = fused.decode_step_fused(params, tokens, pos, cplain,
                                                 config, staged_kv="uniform",
                                                 attn_dots="i8")
        ref, got = logits.cpu(), kern_logits[step].cpu()
        rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
        assert rel <= 1e-5, rel
        assert torch.equal(got.argmax(-1), ref.argmax(-1))
        tokens = logits.argmax(-1)
    for name in ("k", "v"):
        assert int((getattr(ckern, name).int()
                    - getattr(cplain, name).int()).abs().max()) <= 1


def _decode_inputs(rng, L, B, KVH, G, D, T):
    t = dict(
        q=rng.normal(size=(B, KVH, G, D)).astype(np.float32),
        k=rng.integers(-127, 128, size=(L, B, KVH, T, D), dtype=np.int8),
        v=rng.integers(-127, 128, size=(L, B, KVH, T, D), dtype=np.int8),
        ks=rng.uniform(0.001, 0.02, size=(L, B, KVH, T)).astype(np.float32),
        vs=rng.uniform(0.001, 0.02, size=(L, B, KVH, T)).astype(np.float32),
        kn=rng.normal(size=(B, KVH, D)).astype(np.float32),
        vn=rng.normal(size=(B, KVH, D)).astype(np.float32))
    return [torch.from_numpy(t[n]) for n in
            ("q", "k", "v", "ks", "vs", "kn", "vn")]


def _attn_close(out, ref, dots):
    if dots == "f32":
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-6)
    else:
        # expf and sum order can flip one int8 probability code
        rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        assert rel <= 1e-4, rel


@pytest.mark.parametrize("dots", ["i8", "f32"])
@pytest.mark.parametrize("G,D", [(1, 128), (2, 32), (4, 128)])
def test_inline_kernel_matches_plain(dev, dots, G, D):
    rng = np.random.default_rng(700 + G + D)
    args = _decode_inputs(rng, 2, 6, 2, G, D, 64)
    pos = torch.tensor([0, 31, 32, 33, 50, 63], dtype=torch.int32)
    ref = AT.flash_decode_q8_plain(*args[:5], 1, pos, block_t=32, dots=dots)
    before = AT.flash_decode_q8.launches
    out = AT.flash_decode_q8(*[a.to(dev) for a in args[:5]], 1, pos.to(dev),
                             block_t=32, dots=dots).cpu()
    assert AT.flash_decode_q8.launches == before + 1
    _attn_close(out, ref, dots)


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("dots", ["i8", "f32"])
@pytest.mark.parametrize("G,D,T", [(1, 128, 256), (4, 128, 512),
                                   (2, 32, 100)])
def test_ab_kernel_matches_plain(dev, staged, dots, G, D, T):
    rng = np.random.default_rng(800 + G + T + staged)
    B = 8
    args = _decode_inputs(rng, 2, B, 2, G, D, T)
    pos = torch.tensor(sorted(rng.integers(0, T + 1, size=B)),
                       dtype=torch.int32)
    pos[0], pos[-1] = 0, T if staged else T - 1
    ref = AT.flash_decode_q8_ab_plain(*args, 1, pos, staged=staged,
                                      dots=dots)
    before = AT.flash_decode_q8_ab.launches
    out = AT.flash_decode_q8_ab(*[a.to(dev) for a in args], 1, pos.to(dev),
                                staged=staged, dots=dots).cpu()
    assert AT.flash_decode_q8_ab.launches == before + 1
    _attn_close(out, ref, dots)


def test_ab_kernel_rejects_a_block_over_256(dev):
    # _ab_blocks gives one block of the whole T when T % 128 != 0: the
    # kernel keeps a block's logits in shared memory, so it raises
    args = [a.to(dev) for a in _decode_inputs(np.random.default_rng(1), 1,
                                              2, 2, 1, 32, 320)]
    with pytest.raises(ValueError, match="256"):
        AT.flash_decode_q8_ab(*args, 0, torch.tensor([3, 9], device=dev))


@pytest.mark.parametrize("B,S,KVH,G,D", [
    (1, 64, 2, 1, 128), (2, 40, 2, 2, 32), (1, 300, 2, 4, 128),
    (1, 129, 1, 3, 64), (1, 512, 4, 1, 128)])
def test_prefill_kernel_matches_plain(dev, B, S, KVH, G, D):
    rng = np.random.default_rng(900 + S + G)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((B, S, KVH * G, D), (B, S, KVH, D),
                             (B, S, KVH, D)))
    ref = AT.flash_prefill_plain(q, k, v)
    before = AT.flash_prefill.launches
    out = AT.flash_prefill(q.to(dev), k.to(dev), v.to(dev)).cpu()
    assert AT.flash_prefill.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-6)


def test_engine_on_card_counts_launches(dev):
    # a tiny engine on the card at max_seq_len 1024: flash prefill per
    # layer and the all-batch decode kernel per layer, exact counts
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
        engine as E, fast_engine as FE)
    config = dataclasses.replace(TINY_MHA, num_layers=2)
    params = fused.quantize_factors_int8_fused(fused.fuse_stacked(
        bench_params.build_compressed_llama_params(config, rank=16, seed=0,
                                                   device=dev)))
    eng = FE.FastServingEngine(params, config, max_slots=2,
                               max_seq_len=1024, flash_attn=True, device=dev)
    counters = (K.quantized_matmul_w4a8_stacked, AT.flash_prefill,
                AT.flash_decode_q8_ab, K.int8_matmul)
    before = [fn.launches for fn in counters]
    eng.submit(E.Request(uid=0, prompt=np.arange(1, 20), max_new_tokens=4))
    (done,) = eng.run()
    L = config.num_layers
    assert done.finished_reason == "length" and len(done.tokens) == 4
    # one prefill and three decode ticks
    assert [fn.launches - b for fn, b in zip(counters, before)] == [
        4 * L * 4, L, 3 * L, 4]
