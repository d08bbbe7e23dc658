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
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    fused, llama, persistent)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    LLAMA2_7B, TINY, TINY_MHA)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import _build
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import megastep as MS

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


def _attn_close(out, ref, dots):
    if dots == "f32":
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-6)
    else:
        # expf and sum order can flip one int8 probability code, or round
        # one bf16 p * v_scale to its other neighbour
        rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        assert rel <= 1e-4, rel


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


@pytest.mark.parametrize("bits,M,N,Kd", [
    (bits, M, 200, 512) for bits in (2, 4, 8)
    for M in (1, 7, 8, 9, 33, 128)] + [
    (4, M, 4096, 11008) for M in (1, 8, 33)])
def test_persistent_kernel_equals_grid_kernel(dev, bits, M, N, Kd):
    # the same exact i32 sums and epilogue: bit for bit, at decode M (the
    # weight stream) and above it (the tile path), N not a multiple of the
    # 32-row group, and down_proj's K (86 chunks of 128 packed bytes)
    rng = np.random.default_rng(450 + bits + M)
    f = 8 // bits
    x = torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32))
    high = 255 if bits == 8 else 256
    packed = torch.from_numpy(
        rng.integers(0, high, size=(2, N, Kd // f), dtype=np.uint8))
    scales = torch.from_numpy(
        rng.uniform(0.001, 0.02, size=(2, N, 1)).astype(np.float32))
    args = (x.to(dev), packed.to(dev), scales.to(dev), 1, bits)
    before = K.quantized_matmul_w4a8_stacked_persistent.launches
    y = K.quantized_matmul_w4a8_stacked_persistent(*args)
    assert K.quantized_matmul_w4a8_stacked_persistent.launches == before + 1
    assert torch.equal(y, K.quantized_matmul_w4a8_stacked(*args))
    _close(y, K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 1,
                                                    bits))


@pytest.mark.parametrize("N,Kd", [(4096, 4096), (4096, 11008)])
@pytest.mark.parametrize("M", [9, 64, 512])
def test_persistent_launch_above_m8_equals_row3(dev, M, N, Kd):
    # above M 8 the persistent launch runs row 3's tile path: the grid
    # launch's bits, and the plain version's on the card
    rng = np.random.default_rng(480 + M + Kd)
    x = torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32))
    packed = torch.from_numpy(
        rng.integers(0, 256, size=(2, N, Kd // 2), dtype=np.uint8))
    scales = torch.from_numpy(
        rng.uniform(0.001, 0.02, size=(2, N, 1)).astype(np.float32))
    args = (x.to(dev), packed.to(dev), scales.to(dev), 1, 4)
    before = K.quantized_matmul_w4a8_stacked_persistent.launches
    y = K.quantized_matmul_w4a8_stacked_persistent(*args)
    assert K.quantized_matmul_w4a8_stacked_persistent.launches == before + 1
    assert torch.equal(y, K.quantized_matmul_w4a8_stacked(*args))
    assert torch.equal(y, K.quantized_matmul_w4a8_stacked_plain(*args))


def test_persistent_kernel_rules(dev):
    # K 24576 at M 8: the old persistent kernel staged M x K activations in
    # shared memory and refused it; the weight stream takes any K the i32
    # sums hold, and gives row 3's launch bit for bit
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.normal(size=(8, 24576)).astype(np.float32))
    packed = torch.from_numpy(
        rng.integers(0, 256, size=(1, 64, 12288), dtype=np.uint8))
    scales = torch.from_numpy(
        rng.uniform(0.001, 0.02, size=(1, 64, 1)).astype(np.float32))
    args = (x.to(dev), packed.to(dev), scales.to(dev), 0, 4)
    y = K.quantized_matmul_w4a8_stacked_persistent(*args)
    assert torch.equal(y, K.quantized_matmul_w4a8_stacked(*args))
    _close(y, K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 0, 4))
    # above M 8 the tile path takes the same K
    x9 = torch.randn((9, 24576), device=dev)
    assert torch.equal(
        K.quantized_matmul_w4a8_stacked_persistent(x9, *args[1:]),
        K.quantized_matmul_w4a8_stacked(x9, *args[1:]))


def _stream_inputs(seed, M, N, Kd, bits, layers=2):
    rng = np.random.default_rng(seed)
    f = 8 // bits
    x = torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32))
    packed = torch.from_numpy(
        rng.integers(0, 256, size=(layers, N, Kd // f), dtype=np.uint8))
    scales = torch.from_numpy(
        rng.uniform(0.001, 0.02, size=(layers, N, 1)).astype(np.float32))
    return x, packed, scales


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("N,Kd", [(200, 512), (1000, 4096), (4096, 11008)])
def test_stream_kernel_equals_grid_kernel(dev, bits, M, N, Kd):
    # the persistent launch's weight stream at every decode M and bit
    # width: row 3's grid launch bit for bit, N not a multiple of 16, and
    # the plain version within its bound
    x, packed, scales = _stream_inputs(530 + 9 * bits + M + N, M, N, Kd,
                                       bits)
    args = (x.to(dev), packed.to(dev), scales.to(dev), 1, bits)
    before = K.quantized_matmul_w4a8_stacked_persistent.launches
    y = K.quantized_matmul_w4a8_stacked_persistent(*args)
    assert K.quantized_matmul_w4a8_stacked_persistent.launches == before + 1
    assert torch.equal(y, K.quantized_matmul_w4a8_stacked(*args))
    _close(y, K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 1,
                                                    bits))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("ctas", [1, 7, 40])
def test_stream_kernel_smaller_grids(dev, bits, ctas):
    # the same bits on a grid of 1, 7 or 40 CTAs (each warp's range, and so
    # every split group's contributors, differs)
    x, packed, scales = _stream_inputs(560 + bits + ctas, 8, 1000, 4096,
                                       bits)
    xq, sx = K.quantize_activations_int8(x.to(dev))
    p, s = packed.to(dev), scales.to(dev)
    full = K._launch_w4a8_stacked(xq, sx, p, s, 1, bits, persistent=True)
    some = K._launch_w4a8_stacked(xq, sx, p, s, 1, bits, persistent=True,
                                  ctas=ctas)
    assert K._w4a8_stream_plan(8, 1000, 4096, bits, 132, ctas)["ctas"] \
        == ctas
    assert torch.equal(full, some)
    assert torch.equal(full, K._launch_w4a8_stacked(xq, sx, p, s, 1, bits))


@pytest.mark.parametrize("M,N,Kd", [(8, 4096, 4096), (3, 4096, 11008),
                                    (8, 200, 512)])
def test_stream_kernel_repeats_and_graph(dev, M, N, Kd):
    # launches repeat bit for bit (the counters are zero again after each),
    # a second stream has counters of its own, and a CUDA graph's replays
    # equal the eager launch
    x, packed, scales = _stream_inputs(570 + M + N, M, N, Kd, 4, layers=3)
    xq, sx = K.quantize_activations_int8(x.to(dev))
    p, s = packed.to(dev), scales.to(dev)

    def launch(layer):
        return K._launch_w4a8_stacked(xq, sx, p, s, layer, 4,
                                      persistent=True)
    eager = [launch(i) for i in range(3)]
    assert all(torch.equal(eager[i], launch(i)) for i in range(3))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = [launch(i) for i in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, other))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [launch(i) for i in (0, 1, 2, 1)]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, eager[i])
                   for o, i in zip(outs, (0, 1, 2, 1)))


def _bf16_inputs(seed, M, N, Kd, layers=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(layers, N, Kd)).astype(np.float32)
                         ).to(torch.bfloat16)
    return x, W


def _bf16_close(y, ref):
    # bf16 x bf16 products are exact in f32 on both sides; only the order
    # of the K f32 sums differs (wgmma and split-K against the CPU's matmul)
    torch.testing.assert_close(y.cpu(), ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("M", [1, 8, 16, 17, 64, 65, 512])
@pytest.mark.parametrize("N,Kd", [(128, 4096), (4096, 128), (4096, 4096),
                                  (200, 136)])
def test_bf16_stacked_kernel_matches_plain(dev, M, N, Kd):
    # both paths (split-K at M <= 16, 128 x 128 tiles above), ragged M, N
    # and K (TMA's zero fill)
    x, W = _bf16_inputs(480 + M + N, M, N, Kd)
    before = K.bf16_matmul_stacked.launches
    y = K.bf16_matmul_stacked(x.to(dev), W.to(dev), 2)
    assert K.bf16_matmul_stacked.launches == before + 1
    _bf16_close(y, K.bf16_matmul_stacked_plain(x, W, 2))


@pytest.mark.parametrize("M", [8, 512])
def test_bf16_stacked_kernel_last_layer(dev, M):
    # the last of 5 layers: a wrong layer offset reads past the stack or
    # another layer
    x, W = _bf16_inputs(490 + M, M, 200, 1088, layers=5)
    y = K.bf16_matmul_stacked(x.to(dev), W.to(dev), 4)
    _bf16_close(y, K.bf16_matmul_stacked_plain(x, W, 4))


@pytest.mark.parametrize("M,N,Kd", [(8, 128, 4096), (16, 4096, 4096),
                                    (3, 200, 11008), (64, 4096, 4096),
                                    (512, 128, 4096), (100, 200, 2056)])
def test_bf16_stacked_kernel_split_k_is_deterministic(dev, M, N, Kd):
    # the partial tiles are summed in split order, whichever CTA is last
    assert K._bf16_stacked_plan(M, N, Kd)["splits"] > 1
    x, W = _bf16_inputs(500 + M, M, N, Kd, layers=2)
    xd, Wd = x.to(dev), W.to(dev)
    ys = [K.bf16_matmul_stacked(xd, Wd, 1) for _ in range(3)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    _bf16_close(ys[0], K.bf16_matmul_stacked_plain(x, W, 1))


@pytest.mark.parametrize("M", [8, 512])
def test_bf16_stacked_kernel_in_cuda_graph(dev, M):
    # tensor maps are kernel parameters: a captured launch replays them
    x, W = _bf16_inputs(510 + M, M, 128, 4096, layers=2)
    xb, Wd = x.to(dev).to(torch.bfloat16), W.to(dev)
    eager = K._launch_bf16_stacked(xb, Wd, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K._launch_bf16_stacked(xb, Wd, 1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K._launch_bf16_stacked(xb, Wd, 1)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_bf16_stacked_kernel_rules(dev):
    W = torch.zeros((2, 64, 64), dtype=torch.bfloat16, device=dev)
    buf = torch.zeros(8 * 64 + 1, dtype=torch.bfloat16, device=dev)
    x = buf[1:].view(8, 64)  # contiguous, 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        K.bf16_matmul_stacked(x, W, 0)
    with pytest.raises(ValueError, match="K % 8"):
        K.bf16_matmul_stacked(torch.zeros((8, 60), device=dev),
                              torch.zeros((2, 64, 60), dtype=torch.bfloat16,
                                          device=dev), 0)


@pytest.mark.parametrize("Kd", [256, 4096])
@pytest.mark.parametrize("N", [300, 1000, 32000])
@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 32, 33, 64, 65, 128, 1024])
def test_int8_kernel_matches_plain(dev, M, N, Kd):
    # the exact i32 sums and one epilogue order: the default launch and
    # each forced tile (swapped at every M, 128-row tiles where N % 4 == 0)
    # equal the plain version on the card bit for bit (the same int8
    # activations: the CPU rounds x / scale in another way now and then);
    # the first shapes also against the plain version on the CPU, within
    # f32 rounding
    rng = np.random.default_rng(500 + M + N + Kd)
    x = torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32))
    w8 = torch.from_numpy(rng.integers(-127, 128, size=(N, Kd),
                                       dtype=np.int8))
    s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(N, 1))
                         .astype(np.float32))
    xd, wd, sd = x.to(dev), w8.to(dev), s.to(dev)
    before = K.int8_matmul.launches
    y = K.int8_matmul(xd, wd, sd)
    assert K.int8_matmul.launches == before + 1
    ref = K.int8_matmul_plain(xd, wd, sd)
    assert torch.equal(y, ref)
    xq, sx = K.quantize_activations_int8(xd)
    for rows in (64, 128) if N % 4 == 0 else (64,):
        assert torch.equal(K._launch_int8_matmul(xq, sx, wd, sd, rows=rows),
                           ref), rows
    if M in (1, 8, 33) and N == 300 and Kd == 256:
        _close(y, K.int8_matmul_plain(x, w8, s))


@pytest.mark.parametrize("rows,cols", [(64, 128), (128, 128), (128, 256)])
@pytest.mark.parametrize("M,N", [(9, 1000), (70, 1000), (130, 300),
                                 (200, 1012), (1000, 4100)])
def test_int8_tile_ragged(dev, M, N, rows, cols):
    # every tile of the kernel at M and N off its tiles (swapped tiles in
    # several M tiles), K off the 128-byte step: bit-equal to the plain
    # version on the card
    rng = np.random.default_rng(1700 + M + N + rows + cols)
    Kd = 4000
    x = torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32)).to(dev)
    w8 = torch.from_numpy(rng.integers(-127, 128, size=(N, Kd),
                                       dtype=np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(N, 1))
                         .astype(np.float32)).to(dev)
    xq, sx = K.quantize_activations_int8(x)
    y = K._launch_int8_matmul(xq, sx, w8, s, rows=rows, cols=cols)
    assert torch.equal(y, K.int8_matmul_plain(x, w8, s))


def test_int8_tile_odd_n_goes_swapped(dev):
    # N % 4 != 0: no TMA store of 128-row tiles; the plan takes swapped
    # tiles of 64 M rows, and forcing the 128-row tiles raises
    rng = np.random.default_rng(1750)
    M, N, Kd = 300, 1001, 512
    x = torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32)).to(dev)
    w8 = torch.from_numpy(rng.integers(-127, 128, size=(N, Kd),
                                       dtype=np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(N, 1))
                         .astype(np.float32)).to(dev)
    assert K._int8_plan(M, N, Kd)["swap"]
    assert torch.equal(K.int8_matmul(x, w8, s), K.int8_matmul_plain(x, w8, s))
    xq, sx = K.quantize_activations_int8(x)
    with pytest.raises(ValueError, match="N % 4"):
        K._launch_int8_matmul(xq, sx, w8, s, rows=128)


@pytest.mark.parametrize("M", [32, 1024])
def test_int8_tile_repeats_and_replays(dev, M):
    # the same bits on a second launch, on two streams at once and in a
    # CUDA graph (the tensor maps are kernel parameters)
    rng = np.random.default_rng(1760 + M)
    x = torch.from_numpy(rng.normal(size=(M, 4096)).astype(np.float32))
    w8 = torch.from_numpy(rng.integers(-127, 128, size=(32000, 4096),
                                       dtype=np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(32000, 1))
                         .astype(np.float32)).to(dev)
    xq, sx = K.quantize_activations_int8(x.to(dev))
    eager = K._launch_int8_matmul(xq, sx, w8, s)
    assert torch.equal(eager, K._launch_int8_matmul(xq, sx, w8, s))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(K._launch_int8_matmul(xq, sx, w8, s))
    torch.cuda.synchronize()
    assert all(torch.equal(o, eager) for o in outs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = K._launch_int8_matmul(xq, sx, w8, s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_int8_tile_rules(dev):
    # K past the i32 bound raises: the kernel has no other route
    x = torch.zeros((32, 133152), device=dev)
    w8 = torch.zeros((8, 133152), dtype=torch.int8, device=dev)
    s = torch.ones((8, 1), device=dev)
    with pytest.raises(ValueError, match="i32"):
        K.int8_matmul(x, w8, s)


@pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
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
    _attn_close(out, ref, dots)


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


@pytest.mark.parametrize("flags,per_step", [
    (dict(staged_kv="uniform", attn_dots="i8", proj_kernel="persistent"),
     [2, 2, 1, 0, 0, 1]),
    (dict(staged_kv="uniform", attn_dots="bf16"), [4, 0, 1, 0, 0, 1]),
    (dict(staged_kv=False, attn_dots="bf16"), [4, 0, 0, 1, 0, 1]),
    (dict(staged_kv=True, attn_dots="bf16", attn_kernel="ab"),
     [4, 0, 0, 0, 1, 1])])
def test_step_options_on_card(dev, flags, per_step, monkeypatch):
    # the persistent o/down launch and bf16 dots on a 2-layer tiny-mha:
    # exact launches per layer, then the same steps through the plain
    # versions on the card from the same glue (an f32 ulp of a sum can flip
    # one int8 code or one bf16 rounding); the persistent step's logits and
    # cache equal the grid step's bit for bit
    config = dataclasses.replace(TINY_MHA, num_layers=2)
    params = fused.quantize_factors_int8_fused(fused.fuse_stacked(
        bench_params.build_compressed_llama_params(config, rank=16, seed=0,
                                                   device=dev)))
    Lk, B, T = config.num_layers, 4, 16
    counters = (K.quantized_matmul_w4a8_stacked,
                K.quantized_matmul_w4a8_stacked_persistent,
                AT.flash_decode_q8_staged, AT.flash_decode_q8,
                AT.flash_decode_q8_ab, K.int8_matmul)
    expect = [n * Lk if i < 5 else n for i, n in enumerate(per_step)]

    def run(**kw):
        cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
        tokens = torch.tensor([1, 2, 3, 4], device=dev)
        out = []
        for step in range(3):
            pos = torch.full((B,), 5 + step, dtype=torch.int32, device=dev)
            before = [fn.launches for fn in counters]
            logits, cache = fused.decode_step_fused(params, tokens, pos,
                                                    cache, config, **kw)
            out.append(([fn.launches - b for fn, b in zip(counters, before)],
                        logits.cpu()))
            tokens = logits.argmax(-1)
        return out, cache

    kern, ckern = run(**flags)
    assert all(launches == expect for launches, _ in kern)
    if flags.get("proj_kernel") == "persistent":
        grid, cgrid = run(**dict(flags, proj_kernel="grid"))
        for (_, a), (_, b) in zip(kern, grid):
            assert torch.equal(a, b)
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(ckern, name), getattr(cgrid, name))
    for name, plain in (
            ("quantized_matmul_w4a8_stacked",
             K.quantized_matmul_w4a8_stacked_plain),
            ("quantized_matmul_w4a8_stacked_persistent",
             K.quantized_matmul_w4a8_stacked_persistent_plain),
            ("int8_matmul", K.int8_matmul_plain)):
        monkeypatch.setattr(K, name, plain)
    for name in ("flash_decode_q8_staged", "flash_decode_q8",
                 "flash_decode_q8_ab"):
        monkeypatch.setattr(AT, name, getattr(AT, name + "_plain"))
    for (_, got), (_, ref) in zip(kern, run(**flags)[0]):
        assert _rel(got, ref) <= 5e-3, _rel(got, ref)
        assert torch.equal(got.argmax(-1), ref.argmax(-1))


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


@pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
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
@pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
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


@pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
@pytest.mark.parametrize("B,KVH,G,D,T", [
    (2, 2, 1, 32, 320), (8, 4, 1, 128, 2000), (1, 2, 7, 64, 7000)])
def test_ab_kernel_rejects_a_block_over_256(dev, dots, B, KVH, G, D, T):
    # The name is kept from when the kernel raised on such blocks. _ab_blocks
    # gives one block of the whole T when T % 128 != 0; the kernel walks a
    # block over 256 tokens in sub-tiles, in passes that recompute the
    # logits (the i8 block is one quantization group), so it matches the
    # plain version at any length: 320 and 2000 (Llama-2-7B heads), and a
    # G 7, D 64 block far over shared memory (7 x 7000 logits)
    rng = np.random.default_rng(T + G)
    args = _decode_inputs(rng, 1, B, KVH, G, D, T)
    pos = torch.from_numpy(rng.integers(T // 2, T, size=B).astype(np.int32))
    pos[-1] = T - 1
    assert AT._ab_blocks(B, KVH, D, T, 64)[1] == T
    for staged in (True, False):
        ref = AT.flash_decode_q8_ab_plain(*args, 0, pos, staged=staged,
                                          dots=dots)
        out = AT.flash_decode_q8_ab(*[a.to(dev) for a in args], 0,
                                    pos.to(dev), staged=staged,
                                    dots=dots).cpu()
        _attn_close(out, ref, dots)


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


@pytest.mark.parametrize("B,S,KVH,G,D", [
    (1, 77, 2, 1, 100), (2, 130, 1, 5, 36), (1, 70, 1, 64, 8),
    (1, 33, 3, 2, 4)])
def test_prefill_kernel_edge_shapes(dev, B, S, KVH, G, D):
    # D not a multiple of 8 or 32 (zero-filled in shared memory), G that
    # does not divide a CTA's 128 rows, G = 64, and operands at 4-byte
    # aligned addresses (the wrapper copies them for TMA)
    rng = np.random.default_rng(930 + S + G + D)
    shapes = ((B, S, KVH * G, D), (B, S, KVH, D), (B, S, KVH, D))
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in shapes)
    ref = AT.flash_prefill_plain(q, k, v)
    moved = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:] = t.reshape(-1).to(dev)
        moved.append(buf[1:].view(t.shape))
    assert all(t.data_ptr() % 16 for t in moved)
    out = AT.flash_prefill(*moved).cpu()
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-6)


def _attention_f64(q, k, v):
    # causal softmax attention in float64, with the f32 scale the kernels
    # multiply by, 8 heads at a time
    B, S, H, D = q.shape
    G = H // k.shape[2]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    out = torch.empty((B, S, H, D), dtype=torch.float64, device=q.device)
    for h0 in range(0, H, 8):
        kv = [h // G for h in range(h0, min(h0 + 8, H))]
        logits = torch.einsum("bshd,bthd->bhst", q[:, :, h0:h0 + 8].double(),
                              k[:, :, kv].double()) * AT._scale_f32(D)
        logits.masked_fill_(~mask, float("-inf"))
        out[:, :, h0:h0 + 8] = torch.einsum(
            "bhst,bthd->bshd", torch.softmax(logits, dim=-1),
            v[:, :, kv].double())
    return out


@pytest.mark.parametrize("S,KVH,G", [(512, 32, 1), (2048, 32, 1),
                                     (2048, 8, 4)])
def test_prefill_kernel_sharp_logits_against_f64(dev, S, KVH, G):
    # q and k times 3 (logits up to ~40), where the rtol/atol gate measures
    # summation order (logits rounded exactly from float64 fail it): the
    # kernel's max-abs error against a float64 attention within 1.25x the
    # plain f32 version's; two launches give the same bits
    rng = np.random.default_rng(950 + S + G)
    D = 128
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(dev) for shape in ((1, S, KVH * G, D), (1, S, KVH, D),
                                      (1, S, KVH, D)))
    q, k = 3 * q, 3 * k
    truth = _attention_f64(q, k, v)
    out = AT.flash_prefill(q, k, v)
    assert torch.equal(out, AT.flash_prefill(q, k, v))
    err = float((out.double() - truth).abs().max())
    plain_err = float((AT.flash_prefill_plain(q, k, v).double()
                       - truth).abs().max())
    print(f"sharp S={S} KVH={KVH} G={G}: kernel {err:.3e}, plain "
          f"{plain_err:.3e} against float64")
    assert err <= 1.25 * plain_err, (err, plain_err)


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


def _grouped_close(y, ref):
    # bf16 x bf16 products are exact in f32 on both sides (wgmma against
    # cuBLAS in f32 on the same bf16 values); only the order of the K f32
    # sums differs (split-K included)
    torch.testing.assert_close(y.cpu(), ref.cpu(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


def _grouped_inputs(rng, M, N, K, bits, G, layers=None):
    f = 8 // bits
    lead = () if layers is None else (layers,)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    packed = torch.from_numpy(rng.integers(
        0, 255 if bits == 8 else 256, size=lead + (N, K // f),
        dtype=np.uint8))
    scales = torch.from_numpy(
        rng.uniform(0.001, 0.02, size=lead + (N, K // G)).astype(np.float32))
    return x, packed, scales


# (N, K, bits) where the packing allows (K / f % 32 == 0); K 320 at 4 bits
# is a plane of 160 bytes, 32 past a multiple of the kernel's 64-byte step
_GROUPED_SHAPES = [(N, Kd, bits) for N, Kd in ((200, 512), (4096, 4096),
                                               (200, 320))
                   for bits in (2, 4, 8) if (Kd * bits // 8) % 32 == 0]


@pytest.mark.parametrize("N,Kd,bits", _GROUPED_SHAPES)
@pytest.mark.parametrize("M", [1, 8, 16, 17, 64, 65, 512])
def test_grouped_kernel_matches_plain(dev, N, Kd, bits, M):
    # both paths (split-K swap-AB at M <= 16, 128 x 128 tiles above), N not
    # a multiple of either tile, the ragged end of a plane (TMA's zero fill
    # of x covers codes that read as -maxq)
    rng = np.random.default_rng(1000 + 10 * bits + M + N + Kd)
    x, packed, scales = _grouped_inputs(rng, M, N, Kd, bits,
                                        _resolve(bits, Kd))
    x, packed, scales = x.to(dev), packed.to(dev), scales.to(dev)
    ref = K.quantized_matmul_plain(x, packed, scales, bits)
    before = K.quantized_matmul.launches
    y = K.quantized_matmul(x, packed, scales, bits)
    assert K.quantized_matmul.launches == before + 1
    _grouped_close(y, ref)


@pytest.mark.parametrize("bits,G", [(2, 16), (4, 32), (8, 48)])
@pytest.mark.parametrize("M", [5, 40])
def test_grouped_kernel_explicit_group(dev, bits, G, M):
    # groups of 16, 32 and 48 values: a scale a 16-byte run, G 48 crossing
    # the 64-byte steps
    rng = np.random.default_rng(1100 + bits + M)
    x, packed, scales = _grouped_inputs(rng, M, 64, 768, bits, G)
    ref = K.quantized_matmul_plain(x, packed, scales, bits, G)
    _grouped_close(K.quantized_matmul(x.to(dev), packed.to(dev),
                                       scales.to(dev), bits, G), ref)


def test_grouped_kernel_input_rules(dev):
    x = torch.zeros(2, 48, device=dev)
    with pytest.raises(ValueError, match="K/f % 32"):
        K.quantized_matmul(x, torch.zeros(4, 24, dtype=torch.uint8,
                                           device=dev),
                            torch.ones(4, 6, device=dev), 4)


@pytest.mark.parametrize("M,N,Kd", [(8, 4096, 4096), (3, 200, 11008),
                                    (16, 4096, 4096), (17, 4096, 4096),
                                    (100, 200, 2048)])
def test_grouped_kernel_split_k_is_deterministic(dev, M, N, Kd):
    # the partial tiles are summed in split order, whichever CTA is last
    assert K._grouped_plan(M, N, Kd, 4)["splits"] > 1
    rng = np.random.default_rng(1150 + M)
    x, packed, scales = _grouped_inputs(rng, M, N, Kd, 4, _resolve(4, Kd))
    args = (x.to(dev), packed.to(dev), scales.to(dev), 4)
    ys = [K.quantized_matmul(*args) for _ in range(3)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    _grouped_close(ys[0], K.quantized_matmul_plain(*args))


@pytest.mark.parametrize("M", [8, 17, 512])
def test_grouped_kernel_in_cuda_graph(dev, M):
    # tensor maps are kernel parameters and the split-K counters of a
    # capture belong to its graph: replays give the eager bits
    rng = np.random.default_rng(1160 + M)
    x, packed, scales = _grouped_inputs(rng, M, 4096, 4096, 4, 512)
    xb = x.to(dev).to(torch.bfloat16)
    packed, scales = packed.to(dev), scales.to(dev)
    eager = K._launch_grouped(xb, packed, scales, 4, 512)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K._launch_grouped(xb, packed, scales, 4, 512)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [K._launch_grouped(xb, packed, scales, 4, 512)
                for _ in range(2)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(out, eager) for out in outs)
    # an eager launch on the capture's stream after the capture
    with torch.cuda.stream(side):
        again = K._launch_grouped(xb, packed, scales, 4, 512)
    torch.cuda.synchronize()
    assert torch.equal(again, eager)


@pytest.mark.parametrize("M", [8, 512])
def test_grouped_kernel_last_layer(dev, M):
    # the last of 5 layers of a stacked slab, read in place: a wrong base
    # reads past the slab or another layer
    rng = np.random.default_rng(1170 + M)
    x, packed, scales = _grouped_inputs(rng, M, 200, 1088, 4,
                                        _resolve(4, 1088), layers=5)
    pd, sd = packed.to(dev), scales.to(dev)
    y = K.quantized_matmul(x.to(dev), pd[4], sd[4], 4)
    _grouped_close(y, K.quantized_matmul_plain(x, packed[4], scales[4], 4))


@pytest.mark.parametrize("M", [8, 40])
def test_grouped_kernel_unaligned_x(dev, M):
    # a bf16 x 2 bytes past a 16-byte boundary is copied for TMA, not
    # refused
    rng = np.random.default_rng(1180 + M)
    x, packed, scales = _grouped_inputs(rng, M, 200, 512, 4, 128)
    buf = torch.zeros(M * 512 + 1, dtype=torch.bfloat16, device=dev)
    xv = buf[1:].view(M, 512)
    xv.copy_(x.to(dev))
    assert xv.data_ptr() % 16
    y = K.quantized_matmul(xv, packed.to(dev), scales.to(dev), 4, 128)
    _grouped_close(y, K.quantized_matmul_plain(xv.float().cpu(), packed,
                                               scales, 4, 128))


def test_grouped_kernel_two_streams(dev):
    # split-K launches on two streams at once: each stream has its own
    # arrival counters, so neither sees the other's arrivals
    rng = np.random.default_rng(1190)
    cases = []
    for M in (8, 17):
        x, packed, scales = _grouped_inputs(rng, M, 4096, 4096, 4, 512)
        args = (x.to(dev).to(torch.bfloat16), packed.to(dev),
                scales.to(dev), 4, 512)
        assert K._grouped_plan(M, 4096, 4096, 4)["splits"] > 1
        cases.append((args, K.quantized_matmul_plain(x, packed, scales, 4)))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[k].append(K._launch_grouped(*cases[k][0]))
    torch.cuda.synchronize()
    for k, (_, ref) in enumerate(cases):
        for y in outs[k]:
            _grouped_close(y, ref)
        assert all(torch.equal(outs[k][0], y) for y in outs[k][1:])


@pytest.mark.slow
@pytest.mark.parametrize("N,Kd", [(4096, 4096), (11008, 4096), (4096, 11008)])
@pytest.mark.parametrize("M", [8, 512])
def test_grouped_kernel_7b_shapes(dev, N, Kd, M):
    rng = np.random.default_rng(1200 + M)
    x, packed, scales = _grouped_inputs(rng, M, N, Kd, 4, _resolve(4, Kd))
    ref = K.quantized_matmul_plain(x.to(dev), packed.to(dev),
                                    scales.to(dev), 4)
    _grouped_close(K.quantized_matmul(x.to(dev), packed.to(dev),
                                       scales.to(dev), 4), ref)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 8, 33])
def test_w4a8_flat_kernel_matches_plain(dev, bits, M):
    rng = np.random.default_rng(1300 + bits + M)
    f = 8 // bits
    x = torch.from_numpy(rng.normal(size=(M, 512)).astype(np.float32))
    packed = torch.from_numpy(rng.integers(
        0, 255 if bits == 8 else 256, size=(200, 512 // f), dtype=np.uint8))
    scales = torch.from_numpy(
        rng.uniform(0.001, 0.02, size=(200, 1)).astype(np.float32))
    ref = K.quantized_matmul_w4a8_plain(x, packed, scales, bits)
    before = (K.quantized_matmul_w4a8.launches,
              K.quantized_matmul_w4a8_stacked.launches)
    y = K.quantized_matmul_w4a8(x.to(dev), packed.to(dev), scales.to(dev),
                                 bits)
    assert (K.quantized_matmul_w4a8.launches,
            K.quantized_matmul_w4a8_stacked.launches) == (before[0] + 1,
                                                           before[1])
    _close(y, ref)


def _tile_inputs(rng, M, N, Kd, bits, layers=3):
    f = 8 // bits
    x = torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32))
    packed = torch.from_numpy(
        rng.integers(0, 256, size=(layers, N, Kd // f), dtype=np.uint8))
    scales = torch.from_numpy(
        rng.uniform(0.001, 0.02, size=(layers, N, 1)).astype(np.float32))
    return x, packed, scales


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("N", [200, 4104])
@pytest.mark.parametrize("M", [17, 33, 64, 100, 128, 512, 1000])
def test_w4a8_tile_equals_rowdot_and_plain(dev, M, N, bits):
    # the exact i32 sums and one epilogue order: the tile path (M above the
    # threshold; N not a multiple of its 128 weight rows; 8-bit codes up to
    # 255) equals the rowdot launch and the plain version bit for bit
    rng = np.random.default_rng(1500 + M + N + bits)
    x, packed, scales = _tile_inputs(rng, M, N, 1024, bits)
    assert K._w4a8_plan(M, N, 1024, bits)["path"] == "tile"
    xd, pd, sd = x.to(dev), packed.to(dev), scales.to(dev)
    before = K.quantized_matmul_w4a8_stacked.launches
    y = K.quantized_matmul_w4a8_stacked(xd, pd, sd, 2, bits)
    assert K.quantized_matmul_w4a8_stacked.launches == before + 1
    xq, sx = K.quantize_activations_int8(xd)
    row = K._launch_w4a8_stacked(xq, sx, pd, sd, 2, bits, path="rowdot")
    assert torch.equal(y, row)
    # the plain version on the card: the same int8 activations (the CPU
    # rounds x / scale in another way now and then)
    assert torch.equal(y, K.quantized_matmul_w4a8_stacked_plain(
        xd, pd, sd, 2, bits))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [17, 128])
def test_w4a8_tile_flat_entry(dev, M, bits):
    rng = np.random.default_rng(1550 + M + bits)
    x, packed, scales = _tile_inputs(rng, M, 200, 2048, bits, layers=1)
    args = (x.to(dev), packed[0].to(dev), scales[0].to(dev), bits)
    assert torch.equal(K.quantized_matmul_w4a8(*args),
                       K.quantized_matmul_w4a8_plain(*args))


@pytest.mark.parametrize("bits,M", [(2, 64), (2, 512), (4, 512)])
def test_w4a8_tile_down_proj(dev, bits, M):
    # K 11008: at 2 bits the planes are 2752 bytes, so the last 128-byte
    # step straddles each plane's end (TMA's zero fill)
    rng = np.random.default_rng(1560 + M + bits)
    x, packed, scales = _tile_inputs(rng, M, 4096, 11008, bits, layers=2)
    plan = K._w4a8_plan(M, 4096, 11008, bits)
    assert plan["straddle"] == (bits == 2)
    xd, pd, sd = x.to(dev), packed.to(dev), scales.to(dev)
    y = K.quantized_matmul_w4a8_stacked(xd, pd, sd, 1, bits)
    assert torch.equal(y, K.quantized_matmul_w4a8_stacked_plain(
        xd, pd, sd, 1, bits))


@pytest.mark.parametrize("rows", [64, 128])
def test_w4a8_tile_repeats_bit_for_bit(dev, rows):
    rng = np.random.default_rng(1570 + rows)
    x, packed, scales = _tile_inputs(rng, 300, 4104, 4096, 4)
    xq, sx = K.quantize_activations_int8(x.to(dev))
    args = (xq, sx, packed.to(dev), scales.to(dev), 2, 4)
    ys = [K._launch_w4a8_stacked(*args, path="tile", rows=rows)
          for _ in range(3)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    assert torch.equal(ys[0], K._launch_w4a8_stacked(*args, path="rowdot"))


def test_w4a8_tile_two_streams(dev):
    # launches on two streams at once share nothing but their inputs
    rng = np.random.default_rng(1580)
    cases = []
    for M in (40, 512):
        x, packed, scales = _tile_inputs(rng, M, 4096, 4096, 4, layers=2)
        xd, pd, sd = x.to(dev), packed.to(dev), scales.to(dev)
        xq, sx = K.quantize_activations_int8(xd)
        cases.append(((xq, sx, pd, sd, 1, 4),
                      K.quantized_matmul_w4a8_stacked_plain(xd, pd, sd, 1,
                                                            4)))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(10):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[k].append(K._launch_w4a8_stacked(*cases[k][0]))
    torch.cuda.synchronize()
    for k, (_, ref) in enumerate(cases):
        assert all(torch.equal(y, ref) for y in outs[k])


@pytest.mark.parametrize("M", [17, 512])
def test_w4a8_tile_in_cuda_graph(dev, M):
    # the tensor maps are kernel parameters: replays give the eager bits
    rng = np.random.default_rng(1590 + M)
    x, packed, scales = _tile_inputs(rng, M, 4096, 4096, 4, layers=2)
    xq, sx = K.quantize_activations_int8(x.to(dev))
    args = (xq, sx, packed.to(dev), scales.to(dev), 1, 4)
    eager = K._launch_w4a8_stacked(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K._launch_w4a8_stacked(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [K._launch_w4a8_stacked(*args) for _ in range(2)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(out, eager) for out in outs)


def test_w4a8_tile_rules(dev):
    # K past the i32 bound raises at prefill M; it never runs rowdot instead
    x = torch.zeros((32, 66560), device=dev)
    packed = torch.zeros((1, 8, 66560 // 2), dtype=torch.uint8, device=dev)
    scales = torch.ones((1, 8, 1), device=dev)
    with pytest.raises(ValueError, match="i32"):
        K.quantized_matmul_w4a8_stacked(x, packed, scales, 0, 4)


@pytest.mark.slow
@pytest.mark.parametrize("N,Kd", [(4096, 4096), (11008, 4096), (4096, 11008)])
def test_w4a8_flat_kernel_7b_shapes(dev, N, Kd):
    rng = np.random.default_rng(1400)
    x = torch.from_numpy(rng.normal(size=(8, Kd)).astype(np.float32)).to(dev)
    packed = torch.from_numpy(rng.integers(0, 256, size=(N, Kd // 2),
                                           dtype=np.uint8)).to(dev)
    scales = torch.from_numpy(rng.uniform(0.001, 0.02, size=(N, 1))
                              .astype(np.float32)).to(dev)
    _close(K.quantized_matmul_w4a8(x, packed, scales, 4),
           K.quantized_matmul_w4a8_plain(x, packed, scales, 4))


@pytest.mark.parametrize("mode", ["grouped", "w4a8"])
def test_unfused_decode_on_card_counts_launches(dev, mode, monkeypatch):
    # stacked.decode_step_batched over a 2-layer tiny-mha model: 7 launches
    # of the mode's kernel per layer (the bf16 head has none), against the
    # same step through the plain versions on the card
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import stacked
    config = dataclasses.replace(TINY_MHA, num_layers=2)
    params = bench_params.build_compressed_llama_params(
        config, rank=16, seed=0, mode=mode, device=dev)
    counter = (K.quantized_matmul if mode == "grouped"
               else K.quantized_matmul_w4a8)
    tokens = torch.tensor([1, 2, 3], device=dev)
    pos = torch.tensor([0, 3, 5], dtype=torch.int32, device=dev)
    caches = [llama.KVCache.create(config, 3, 16, device=dev)
              for _ in range(2)]
    before = counter.launches
    got, _ = stacked.decode_step_batched(params, tokens, pos, caches[0],
                                         config)
    assert counter.launches == before + 7 * config.num_layers
    monkeypatch.setattr(K, "quantized_matmul", K.quantized_matmul_plain)
    monkeypatch.setattr(K, "quantized_matmul_w4a8",
                        K.quantized_matmul_w4a8_plain)
    ref, _ = stacked.decode_step_batched(params, tokens, pos, caches[1],
                                         config)
    rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    # grouped: f32 sum order can move a bf16 cast by one ulp; w4a8: exact
    # kernels, an int8 activation code can still flip at a knife edge
    assert rel <= 5e-3, rel


def _resolve(bits, Kd):
    return K.resolve_group(bits, Kd, None)


def _paged_inputs(rng, L, NP, KVH, P, G, D, B, max_pages):
    t = dict(
        q=rng.normal(size=(B, KVH, G, D)).astype(np.float32),
        k=rng.integers(-127, 128, size=(L, NP, KVH, P, D), dtype=np.int8),
        v=rng.integers(-127, 128, size=(L, NP, KVH, P, D), dtype=np.int8),
        ks=rng.uniform(0.001, 0.02, size=(L, NP, KVH, P)).astype(np.float32),
        vs=rng.uniform(0.001, 0.02, size=(L, NP, KVH, P)).astype(np.float32),
        kn=rng.normal(size=(B, KVH, D)).astype(np.float32),
        vn=rng.normal(size=(B, KVH, D)).astype(np.float32))
    tables = rng.permutation(NP)[:B * max_pages].reshape(B, max_pages)
    return ([torch.from_numpy(t[n]) for n in
             ("q", "k", "v", "ks", "vs", "kn", "vn")],
            torch.from_numpy(tables.astype(np.int32)))


@pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
@pytest.mark.parametrize("P,G,D", [(16, 1, 128), (32, 2, 32), (256, 4, 128),
                                   (320, 1, 32), (512, 2, 64)])
def test_paged_kernel_matches_plain(dev, dots, P, G, D):
    rng = np.random.default_rng(1000 + P + G)
    B, max_pages = 6, 4
    args, tables = _paged_inputs(rng, 2, B * max_pages + 3, 2, P, G, D, B,
                                 max_pages)
    T = P * max_pages
    pos = torch.tensor([0, 1, P, P + 1, T - 1, T], dtype=torch.int32)
    ref = AT.flash_decode_q8_paged_plain(*args, 1, tables, pos, dots=dots)
    before = AT.flash_decode_q8_paged.launches
    out = AT.flash_decode_q8_paged(*[a.to(dev) for a in args], 1,
                                   tables.to(dev), pos.to(dev),
                                   dots=dots).cpu()
    assert AT.flash_decode_q8_paged.launches == before + 1
    _attn_close(out, ref, dots)


def test_paged_kernel_rules(dev):
    rng = np.random.default_rng(1100)
    args, tables = _paged_inputs(rng, 1, 8, 2, 16, 1, 32, 2, 4)
    args = [a.to(dev) for a in args]
    pos = torch.tensor([3, 40], dtype=torch.int32, device=dev)
    bad = tables.clone()
    bad[1, 3] = 8
    with pytest.raises(IndexError, match="out of range"):
        AT.flash_decode_q8_paged(*args, 0, bad.to(dev), pos)
    with pytest.raises(ValueError, match="shape mismatch"):
        AT.flash_decode_q8_paged(*args, 0, tables.to(dev), pos[:1])
    # a page of 320 tokens (it raised when blocks were capped at 256): the
    # plain version's result
    big, big_tables = _paged_inputs(rng, 1, 2, 2, 320, 1, 32, 2, 1)
    for dots in ("i8", "f32", "bf16"):
        ref = AT.flash_decode_q8_paged_plain(*big, 0, big_tables, pos.cpu(),
                                             dots=dots)
        out = AT.flash_decode_q8_paged(*[a.to(dev) for a in big], 0,
                                       big_tables.to(dev), pos, dots=dots)
        _attn_close(out.cpu(), ref, dots)


def _pool_of(cache, P):
    """A contiguous (L, B, KVH, T, D[...]) cache as a pool of P-token pages
    (L, B * T / P, KVH, P[, D]) whose row b holds pages b * T / P ... in
    order: the identity page tables."""
    L, B, KVH, T = cache.shape[:4]
    n = T // P
    return (cache.reshape(L, B, KVH, n, P, *cache.shape[4:])
            .transpose(2, 3).reshape(L, B * n, KVH, P, *cache.shape[4:])
            .contiguous())


@pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
@pytest.mark.parametrize("P", [1, 16, 320, 512])
@pytest.mark.parametrize("G,D", [(1, 128), (4, 64), (7, 32)])
def test_paged_split_equals_staged_kernel(dev, dots, P, G, D):
    # identity tables with pages of the staged kernel's block: the
    # block-parallel kernel computes the staged kernel's walk bit for bit.
    # At pages of 1 and 16 tokens the tables hold 2048 tokens, so the last
    # rows run several chunks, several windows and a combine over several
    # stages (A, B and C items, not whole streams)
    rng = np.random.default_rng(1200 + P + G)
    B, KVH = 6, 2
    max_pages = 2048 // P if P <= 16 else 2
    T = P * max_pages
    if P <= 16:
        plan = AT._decode_split_plan(B, KVH, G, D, T, P, 132)
        assert T - 1 > max(AT._SPLIT_CHUNK, plan["whole_tokens"])
        assert -(-(T - 1) // P) > 2 * plan["nbw"]
        # the combine reads a stream's blocks in stages of
        # _SPLIT_WHOLE_BYTES / 4 words
        assert plan["nblk"] * (G * D + 4 * G) > AT._SPLIT_WHOLE_BYTES // 2
    args = [a.to(dev) for a in _decode_inputs(rng, 2, B, KVH, G, D, T)]
    q, k, v, ks, vs, kn, vn = args
    pool = [_pool_of(t, P) for t in (k, v, ks, vs)]
    tables = torch.arange(B * max_pages, dtype=torch.int32,
                          device=dev).reshape(B, max_pages)
    pos = torch.tensor([0, 1, P, P + 1, T - 1, T], dtype=torch.int32,
                       device=dev)
    out = AT.flash_decode_q8_paged(q, *pool, kn, vn, 1, tables, pos,
                                   dots=dots)
    row = AT.flash_decode_q8_staged(*args, 1, pos, block_t=P, dots=dots)
    assert torch.equal(out, row)


@pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
@pytest.mark.parametrize("T", [100, 256, 512, 320, 2000])
@pytest.mark.parametrize("G,D", [(1, 128), (4, 64), (7, 32)])
def test_ab_split_equals_row_kernels(dev, dots, T, G, D):
    # the all-batch kernel equals the staged and inline row kernels walking
    # the same blocks (_ab_blocks: 128-token blocks, or one block of the
    # whole T when T % 128 != 0, here up to 2000 tokens)
    rng = np.random.default_rng(1300 + T + G)
    B, KVH = 6, 2
    args = [a.to(dev) for a in _decode_inputs(rng, 2, B, KVH, G, D, T)]
    bt = AT._ab_blocks(B, KVH, D, T, 64)[1]
    for staged in (True, False):
        pos = torch.tensor([0, 1, bt - 1, bt, T - 1, T if staged else T - 1],
                           dtype=torch.int32, device=dev)
        out = AT.flash_decode_q8_ab(*args, 1, pos, staged=staged, dots=dots)
        row = (AT.flash_decode_q8_staged(*args, 1, pos, block_t=bt,
                                         dots=dots) if staged else
               AT.flash_decode_q8(*args[:5], 1, pos, block_t=bt, dots=dots))
        assert torch.equal(out, row), staged


@pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
def test_split_over_128_rows_equals_row_kernels(dev, dots):
    # the kernel takes its rows in tiles of 128: 260 rows (three tiles) at
    # random positions, all-batch (128-token blocks, staged and inline) and
    # paged (16-token pages, identity tables), each equal to the row
    # kernels' walk bit for bit
    rng = np.random.default_rng(1500)
    B, KVH, G, D, T, P = 260, 2, 2, 64, 512, 16
    args = [a.to(dev) for a in _decode_inputs(rng, 2, B, KVH, G, D, T)]
    pos = torch.from_numpy(rng.integers(0, T, size=B).astype(np.int32))
    pos[:4] = torch.tensor([0, 1, T - 1, 200], dtype=torch.int32)
    pos = pos.to(dev)
    for staged in (True, False):
        out = AT.flash_decode_q8_ab(*args, 1, pos, staged=staged, dots=dots)
        row = (AT.flash_decode_q8_staged(*args, 1, pos, block_t=128,
                                         dots=dots) if staged else
               AT.flash_decode_q8(*args[:5], 1, pos, block_t=128, dots=dots))
        assert torch.equal(out, row), staged
    pool = [_pool_of(t, P) for t in args[1:5]]
    tables = torch.arange(B * (T // P), dtype=torch.int32,
                          device=dev).reshape(B, T // P)
    out = AT.flash_decode_q8_paged(args[0], *pool, *args[5:], 1, tables, pos,
                                   dots=dots)
    row = AT.flash_decode_q8_staged(*args, 1, pos, block_t=P, dots=dots)
    assert torch.equal(out, row)


@pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
def test_split_graph_replay_equals_eager(dev, dots):
    # the paged and all-batch launches read nothing back to the host: each
    # captures into a CUDA graph, and a replay gives the eager bits
    rng = np.random.default_rng(1400)
    B, KVH, G, D, P, max_pages = 4, 2, 2, 64, 16, 8
    args, tables = _paged_inputs(rng, 2, B * max_pages + 2, KVH, P, G, D, B,
                                 max_pages)
    args, tables = [a.to(dev) for a in args], tables.to(dev)
    pos = torch.tensor([0, 17, 100, 128], dtype=torch.int32, device=dev)
    ab_args = [a.to(dev) for a in _decode_inputs(rng, 2, B, KVH, G, D, 512)]
    ab_pos = torch.tensor([0, 129, 300, 511], dtype=torch.int32, device=dev)

    def run():
        return (AT._flash_decode_q8_paged(*args, 1, tables, pos, dots=dots),
                AT.flash_decode_q8_ab(*ab_args, 1, ab_pos, staged=True,
                                      dots=dots),
                AT.flash_decode_q8_ab(*ab_args, 0, ab_pos, staged=False,
                                      dots=dots))

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for out in captured:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for got, ref in zip(captured, eager):
        assert torch.equal(got, ref)


# the row kernel (csrc/flash_decode.cu) against the block-parallel kernel
# at the same block: both compute the walk's function bit for bit.
# (B, KVH, T, block, attended positions): one row over 4096 tokens at its
# last position (clusters of 8 CTAs, two blocks each), mixed positions over
# 2048, the bench shape, 260 rows, a 2000-token cache (125 blocks of 16
# tokens; at G >= 4 more than eight CTAs' shared memory holds, the wrappers'
# split route), 4-token blocks (T 300), and one 2000-token block (the walk)
_ROW_SHAPES = [
    (1, 2, 4096, None, [4095]),
    (8, 2, 2048, None, [0, 1, 255, 256, 700, 1999, 2047, 2048]),
    (8, 4, 256, None, [128, 128, 0, 1, 255, 256, 200, 129]),
    (260, 1, 512, None, None),
    (4, 2, 2000, None, [0, 1, 1000, 2000]),
    (3, 2, 300, None, [0, 150, 300]),
    (4, 2, 2000, 2000, [0, 1, 1000, 2000]),
]


def _row_and_split(dev, seed, B, KVH, G, D, T, pos, dots, bt=None):
    """(row kernel, split kernel) outputs, staged then inline, at the
    wrappers' block (resolve_block_t(256, T)) unless ``bt``."""
    rng = np.random.default_rng(seed)
    args = [a.to(dev) for a in _decode_inputs(rng, 2, B, KVH, G, D, T)]
    if pos is None:
        pos = rng.integers(0, T + 1, size=B).tolist()
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    bt = bt or AT.resolve_block_t(256, T)
    got = []
    for staged in (True, False):
        entry = ("flash_decode_staged_launch" if staged
                 else "flash_decode_inline_launch")
        news = args[5:] if staged else (None, None)
        out = AT._launch_decode(entry, *args[:5], *news, 1, p, bt, dots)
        ref = AT._launch_split(*args, 1, p, bt, dots, staged)
        got.append((out, ref))
    return got


@pytest.mark.parametrize("dots", ["i8", "f32", "bf16"])
@pytest.mark.parametrize("G,D", [(1, 128), (4, 128), (7, 64), (8, 64)])
@pytest.mark.parametrize("shape", range(len(_ROW_SHAPES)))
def test_row_kernel_equals_split_kernel(dev, dots, G, D, shape):
    B, KVH, T, bt, pos = _ROW_SHAPES[shape]
    for out, ref in _row_and_split(dev, 2000 + 10 * shape + G, B, KVH, G, D,
                                   T, pos, dots, bt=bt):
        assert torch.equal(out, ref)


@pytest.mark.parametrize("dots", ["i8", "f32"])
@pytest.mark.parametrize("KVH,C", [(2, 8), (8, 4), (16, 3), (32, 2), (33, 1)])
def test_row_kernel_cluster_sizes(dev, dots, KVH, C):
    # every cluster size the plan takes gives the same bits: B 8 rows over 8
    # blocks (GQA heads over 2048 tokens; one head over 128 in 16-token
    # blocks) at mixed positions, the cluster set by the streams
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for G, T, bt in ((4, 2048, 256), (1, 128, 16)):
        plan = AT._row_decode_plan(8, KVH, G, 128, T, bt, sms)
        assert plan["cluster"] == C, f"{sms} SMs: {plan}"
        pos = [0, 1, 17, T // 3, T // 2, T - 1, T, bt]
        for out, ref in _row_and_split(dev, 2100 + C, 8, KVH, G, 128, T,
                                       pos, dots, bt=bt):
            assert torch.equal(out, ref), G


def test_row_kernel_graph_and_second_stream(dev):
    # the launch reads nothing back to the host: a CUDA-graph replay and a
    # launch on a second stream give the eager bits
    rng = np.random.default_rng(2200)
    B, KVH, G, D, T = 8, 8, 4, 128, 2048
    args = [a.to(dev) for a in _decode_inputs(rng, 2, B, KVH, G, D, T)]
    pos = torch.tensor([0, 1, 300, 511, 512, 1999, 2047, 2048],
                       dtype=torch.int32, device=dev)

    def run():
        return [AT.flash_decode_q8_staged(*args, 1, pos, dots=dots)
                for dots in ("i8", "f32", "bf16")] + [
            AT.flash_decode_q8(*args[:5], 0, pos, dots="i8")]

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for got, ref in zip(other, eager):
        assert torch.equal(got, ref)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for out in captured:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for got, ref in zip(captured, eager):
        assert torch.equal(got, ref)


def test_row_plan_shared_memory_mirror(dev):
    # the launch refuses a plan whose shared memory is not the kernel's own
    # count, so each launch holds the plan's mirror to the layout: the
    # default plans of the main paths' shapes, and the longest caches of
    # Llama-3-8B's and Qwen2-0.5B's heads the row kernel takes, run it and
    # equal the split kernel
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, KVH, G, D, T in ((8, 32, 1, 128, 256), (8, 8, 4, 128, 2048),
                            (1, 32, 1, 128, 4096), (8, 2, 7, 64, 2048),
                            (3, 2, 8, 64, 300), (2, 1, 8, 16, 64),
                            (2, 8, 4, 128, 16384), (8, 2, 7, 64, 14336)):
        bt = AT.resolve_block_t(256, T)
        plan = AT._row_decode_plan(B, KVH, G, D, T, bt, sms)
        assert plan["route"] == "row", (B, KVH, G, D, T)
        pos = np.linspace(0, T, B).astype(int).tolist()
        for out, ref in _row_and_split(dev, 2400 + T, B, KVH, G, D, T, pos,
                                       "i8"):
            assert torch.equal(out, ref), (B, KVH, G, D, T)


def test_row_kernel_long_cache_takes_split_route(dev):
    # past the row kernel's shared memory (Qwen2-0.5B's heads over 16384
    # tokens, Llama-3-8B's over 16640) the wrappers launch the split kernel
    # and count the launch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, KVH, G, D, T, bt in ((2, 2, 7, 64, 16384, 256),
                                (2, 8, 4, 128, 16640, 256)):
        assert AT._row_decode_plan(B, KVH, G, D, T, bt, sms)["route"] == \
            "split"
        rng = np.random.default_rng(2500 + T)
        args = [a.to(dev) for a in _decode_inputs(rng, 2, B, KVH, G, D, T)]
        pos = torch.tensor([T // 2, T], dtype=torch.int32, device=dev)
        before = (AT.flash_decode_q8_staged.launches,
                  AT.flash_decode_q8.launches)
        staged = AT.flash_decode_q8_staged(*args, 1, pos, block_t=bt,
                                           dots="i8")
        inline = AT.flash_decode_q8(*args[:5], 1, pos, block_t=bt,
                                    dots="i8")
        assert (AT.flash_decode_q8_staged.launches,
                AT.flash_decode_q8.launches) == (before[0] + 1,
                                                 before[1] + 1)
        assert torch.equal(staged, AT._launch_split(*args, 1, pos, bt, "i8",
                                                    True))
        assert torch.equal(inline, AT._launch_split(*args, 1, pos, bt, "i8",
                                                    False))


def test_row_kernel_rules(dev):
    rng = np.random.default_rng(2300)
    args = [a.to(dev) for a in _decode_inputs(rng, 2, 2, 2, 9, 64, 256)]
    pos = torch.tensor([10, 20], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="csrc/flash_decode.cu takes G <= 8"):
        AT.flash_decode_q8_staged(*args, 1, pos)
    with pytest.raises(ValueError, match="csrc/flash_decode_split.cu takes"):
        AT.flash_decode_q8_ab(*args, 1, pos, staged=True)
    # a plan whose shared memory differs from the kernel's layout is refused
    # (cudaErrorInvalidValue) before anything is launched
    args = [a.to(dev) for a in _decode_inputs(rng, 2, 2, 2, 1, 64, 512)]
    plan = AT._row_decode_plan(2, 2, 1, 64, 512, 256, 132)
    out = torch.empty((2, 2, 1, 64), device=dev)
    ptrs = [t.data_ptr() for t in args[:5]] + [pos.data_ptr(),
                                               out.data_ptr()]
    lib = _build.library("flash_decode")
    for smem in (plan["smem"] + 128, plan["smem"] - 128):
        err = lib.flash_decode_inline_launch(
            *ptrs, 2, 2, 1, 64, 512, 256, 0.125, 2, plan["cluster"],
            plan["nbw"], plan["maxb"], smem, _build.stream_ptr(dev))
        assert err == 1, smem


def test_paged_engine_on_card_counts_launches(dev):
    # a tiny paged engine on the card: flash prefill and the paged decode
    # kernel per layer, exact counts, and the same greedy tokens as its
    # first tick through the plain versions
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
        engine as E, paged_engine as PE)
    config = dataclasses.replace(TINY_MHA, num_layers=2)
    params = fused.quantize_factors_int8_fused(fused.fuse_stacked(
        bench_params.build_compressed_llama_params(config, rank=16, seed=0,
                                                   device=dev)))
    eng = PE.PagedServingEngine(params, config, max_slots=2, num_pages=16,
                                page_size=16, flash_attn=True, device=dev)
    counters = (K.quantized_matmul_w4a8_stacked, AT.flash_prefill,
                AT.flash_decode_q8_paged, K.int8_matmul)
    before = [fn.launches for fn in counters]
    eng.submit(E.Request(uid=0, prompt=np.arange(1, 20), max_new_tokens=4))
    (done,) = eng.run()
    L = config.num_layers
    assert done.finished_reason == "length" and len(done.tokens) == 4
    assert [fn.launches - b for fn, b in zip(counters, before)] == [
        4 * L * 4, L, 3 * L, 4]
    assert eng.allocator.free_pages == 16


def _lowrank_group(rng, layers, splits, K, rank, bits, M):
    f = 8 // bits
    N, nR = sum(splits), len(splits) * rank
    high = 255 if bits == 8 else 256
    return dict(
        x=torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)),
        packed=torch.from_numpy(rng.integers(0, high, size=(layers, N, K // f),
                                             dtype=np.uint8)),
        scales=torch.from_numpy(rng.uniform(1e-3, 1e-2, size=(layers, N, 1))
                                .astype(np.float32)),
        R=torch.from_numpy(rng.integers(-127, 128, size=(layers, nR, K),
                                        dtype=np.int8)),
        Rs=torch.from_numpy(rng.uniform(1e-4, 1e-3, size=(layers, nR, 1))
                            .astype(np.float32)),
        L=torch.from_numpy(rng.integers(-127, 128, size=(layers, N, rank),
                                        dtype=np.int8)),
        Ls=torch.from_numpy(rng.uniform(1e-4, 1e-3, size=(layers, N, 1))
                            .astype(np.float32)))


def _rel(got, ref):
    got, ref = got.cpu(), ref.cpu()
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


# splits whose row tiles straddle two and three projections (tiles of 32
# rows at M <= 8, 8 rows above), and a single projection of any rank
_SPLITS = [((40, 24, 136), 128), ((512, 256, 256), 128), ((96,), 24)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 8, 33])
@pytest.mark.parametrize("splits,rank", _SPLITS)
def test_l_kernel_matches_plain(dev, splits, rank, M, bits):
    # exact integer sums; the factor dots sum in another f32 order
    g = _lowrank_group(np.random.default_rng(700 + M + bits), 2, splits, 256,
                       rank, bits, M)
    xr = K.thin_xr(g["x"], g["R"][1], g["Rs"][1])
    args = (g["packed"], g["scales"], 1, xr, g["L"], g["Ls"], bits, rank,
            splits)
    ref = K.quantized_matmul_w4a8_l_stacked_plain(g["x"], *args)
    before = K.quantized_matmul_w4a8_l_stacked.launches
    y = K.quantized_matmul_w4a8_l_stacked(
        g["x"].to(dev), *(a.to(dev) if torch.is_tensor(a) else a
                          for a in args))
    assert K.quantized_matmul_w4a8_l_stacked.launches == before + 1
    torch.testing.assert_close(y.cpu(), ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


def _l_tile_case(dev, seed, splits, rank, M, bits, Kd=256):
    g = _lowrank_group(np.random.default_rng(seed), 2, splits, Kd, rank,
                       bits, M)
    d = {k: t.to(dev) for k, t in g.items()}
    d["xr"] = K.thin_xr(d["x"], d["R"][1], d["Rs"][1])
    xq, sx = K.quantize_activations_int8(d["x"])
    return d, (xq, sx, d["packed"], d["scales"], 1, d["xr"], d["L"],
               d["Ls"], bits, rank, splits)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [9, 33, 100, 1000])
@pytest.mark.parametrize("splits,rank", _SPLITS + [((200,), 300)])
def test_l_tile_matches_plain(dev, splits, rank, M, bits):
    # above the decode threshold the tile path (int8 wgmma, the L epilogue
    # on bf16 wgmma; tiles that straddle three projections, rank 24 in one
    # 64-rank sub-step, rank 300 in five with one value a load) against the
    # plain version on the card: exact integer sums, the factor dots in
    # another f32 order
    d, largs = _l_tile_case(dev, 1700 + M + bits, splits, rank, M, bits)
    assert K._w4a8_l_plan(M, sum(splits), 256, bits, rank,
                          splits)["path"] == "tile"
    args = (d["packed"], d["scales"], 1, d["xr"], d["L"], d["Ls"], bits, rank,
            splits)
    before = K.quantized_matmul_w4a8_l_stacked.launches
    y = K.quantized_matmul_w4a8_l_stacked(d["x"], *args)
    assert K.quantized_matmul_w4a8_l_stacked.launches == before + 1
    ref = K.quantized_matmul_w4a8_l_stacked_plain(d["x"], *args)
    torch.testing.assert_close(y, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(y, K._launch_l(*largs))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("splits,rank", _SPLITS)
def test_l_tile_against_l_kernel(dev, splits, rank, bits):
    # the tile launch against a launch of the decode design (l_kernel,
    # forced) on the same codes: the same integer sums, the factor sums in
    # another f32 order
    _, largs = _l_tile_case(dev, 1750 + bits, splits, rank, 100, bits)
    y = K._launch_l(*largs, path="tile")
    row = K._launch_l(*largs, path="rowdot")
    torch.testing.assert_close(y, row, rtol=1e-5,
                               atol=1e-5 * float(row.abs().max()))


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("splits,rank", _SPLITS)
def test_l_tile_repeats_bit_for_bit(dev, splits, rank, rows):
    _, largs = _l_tile_case(dev, 1760 + rows, splits, rank, 300, 4, 1024)
    ys = [K._launch_l(*largs, path="tile", rows=rows) for _ in range(3)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("splits,rank", _SPLITS)
def test_l_tile_zero_factors_equal_w4a8_tile(dev, splits, rank, rows, bits):
    # with L = 0 the L epilogue adds exact zeros: the output is row 3's
    # tile path bit for bit, and the decode design's
    d, largs = _l_tile_case(dev, 1770 + rows + bits, splits, rank, 200, bits,
                            512)
    largs = list(largs)
    largs[6] = torch.zeros_like(d["L"])
    xq, sx, packed, scales = largs[:4]
    y = K._launch_l(*largs, path="tile", rows=rows)
    assert torch.equal(y, K._launch_w4a8_stacked(
        xq, sx, packed, scales, 1, bits, path="tile", rows=rows))
    assert torch.equal(y, K._launch_l(*largs, path="rowdot"))


def test_l_tile_rules(dev):
    # K past the tile kernel's i32 bound raises at prefill M; it never runs
    # the decode design instead
    Kd, rank = 66560, 16
    x = torch.zeros((32, Kd), device=dev)
    packed = torch.zeros((1, 8, Kd // 2), dtype=torch.uint8, device=dev)
    ones = torch.ones((1, 8, 1), device=dev)
    L = torch.zeros((1, 8, rank), dtype=torch.int8, device=dev)
    xr = torch.zeros((32, rank), device=dev)
    with pytest.raises(ValueError, match="i32"):
        K.quantized_matmul_w4a8_l_stacked(x, packed, ones, 0, xr, L, ones, 4,
                                          rank, (8,))


def _lr_case(dev, seed, splits, rank, M, bits, Kd=512):
    g = _lowrank_group(np.random.default_rng(seed), 2, splits, Kd, rank,
                       bits, M)
    d = {k: t.to(dev) for k, t in g.items()}
    xq, sx = K.quantize_activations_int8(d["x"])
    return d, (d["x"], xq, sx, d["packed"], d["scales"], 1, d["R"], d["Rs"],
               d["L"], d["Ls"], bits, rank, splits)


@pytest.mark.parametrize("path", [None, "coop", "tile"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 8, 9, 33, 130, 512])
@pytest.mark.parametrize("splits,rank", _SPLITS)
def test_lr_kernel_matches_plain(dev, splits, rank, M, bits, path):
    # each design (None: the plan's, through the public wrapper) at decode
    # and prefill M. xr (the cooperative kernel's first phase, or the
    # tensor-core xr kernel) against the plain thin dot (f32 sums in
    # another order), then the output against the plain version on the
    # kernel's own xr: an xr element that rounds to the other bf16
    # neighbour before the L dot moved outputs by up to 4.7e-4 (1.1e-4 of
    # their largest), so the output is not held to the plain xr. A second
    # launch gives the same bits.
    d, largs = _lr_case(dev, 800 + M + bits, splits, rank, M, bits)
    y, xr = K._launch_lr(*largs, path=path)
    if path is None:
        before = K.quantized_matmul_w4a8_lr_stacked.launches
        y_pub = K.quantized_matmul_w4a8_lr_stacked(
            d["x"], d["packed"], d["scales"], 1, d["R"], d["Rs"], d["L"],
            d["Ls"], bits, rank, splits)
        assert K.quantized_matmul_w4a8_lr_stacked.launches == before + 1
        assert torch.equal(y, y_pub)
    y2, xr2 = K._launch_lr(*largs, path=path)
    assert torch.equal(y, y2) and torch.equal(xr, xr2)
    xr_ref = K.thin_xr(d["x"], d["R"][1], d["Rs"][1])
    torch.testing.assert_close(xr, xr_ref, rtol=1e-5,
                               atol=1e-5 * float(xr_ref.abs().max()))
    ref = K.quantized_matmul_w4a8_l_stacked_plain(
        d["x"], d["packed"], d["scales"], 1, xr, d["L"], d["Ls"], bits, rank,
        splits)
    torch.testing.assert_close(y, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("path", ["coop", "tile"])
@pytest.mark.parametrize("M", [8, 33, 512])
@pytest.mark.parametrize("splits,rank", _SPLITS)
def test_lr_zero_factors_equal_w4a8(dev, splits, rank, M, path):
    # with L = 0 the epilogue adds exact zeros: the integer half is the
    # stacked W4A8 kernel's (rowdot or its tile path) bit for bit
    d, largs = _lr_case(dev, 850 + M, splits, rank, M, 4)
    largs = list(largs)
    largs[8] = torch.zeros_like(d["L"])
    y, _ = K._launch_lr(*largs, path=path)
    assert torch.equal(y, K.quantized_matmul_w4a8_stacked(
        d["x"], d["packed"], d["scales"], 1, 4))


@pytest.mark.parametrize("xr_cols", [16, 64, 128])
@pytest.mark.parametrize("xr_split_steps", [1, 3, None])
def test_lr_xr_kernel_tiles_and_splits(dev, xr_cols, xr_split_steps):
    # every tile width and split count of the xr kernel, ragged M, nR and K
    # (rank 130 x 3 projections: 390 R rows; K 4160: 65 steps of 64), each
    # within the bound of the plain thin dot, its bf16 copy in the L tile
    # kernel's layout, repeating bit for bit
    splits, rank, M, Kd = (128, 128, 128), 130, 70, 4160
    d, largs = _lr_case(dev, 870 + xr_cols, splits, rank, M, 4, Kd)
    plan = K._xr_plan(M, 3 * rank, Kd, cols=xr_cols,
                      split_steps=xr_split_steps)
    ops = (d["x"].to(torch.bfloat16), d["R"][1], d["Rs"][1], rank)
    xr, xr_b = K._launch_lr_xr(*ops, plan)
    xr_ref = K.thin_xr(d["x"], d["R"][1], d["Rs"][1])
    torch.testing.assert_close(xr, xr_ref, rtol=1e-5,
                               atol=1e-5 * float(xr_ref.abs().max()))
    # its bf16 copy is the L tile kernel's operand, zeros past the rank
    assert torch.equal(xr_b, K._l_tile_operands(xr, d["L"][1], rank, 3)[0])
    again = K._launch_lr_xr(*ops, plan)
    assert torch.equal(xr, again[0]) and torch.equal(xr_b, again[1])


def test_lr_tile_two_streams(dev):
    # split-K xr launches on two streams at once: each stream has its own
    # arrival counters, so neither sees the other's arrivals
    cases = []
    for M in (40, 512):
        d, largs = _lr_case(dev, 880 + M, (512, 256, 256), 128, M, 4, 4096)
        assert K._w4a8_lr_plan(M, 1024, 4096, 4, 128,
                               (512, 256, 256))["xr"]["splits"] > 1
        cases.append((largs, K._launch_lr(*largs)))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(10):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[k].append(K._launch_lr(*cases[k][0]))
    torch.cuda.synchronize()
    for k, (_, (y, xr)) in enumerate(cases):
        assert all(torch.equal(o[0], y) and torch.equal(o[1], xr)
                   for o in outs[k])


@pytest.mark.parametrize("M", [17, 512])
def test_lr_tile_in_cuda_graph(dev, M):
    # tensor maps are kernel parameters and the xr kernel's split-K
    # counters of a capture belong to its graph: replays give the eager bits
    d, largs = _lr_case(dev, 890 + M, (512, 256, 256), 128, M, 4, 4096)
    eager, _ = K._launch_lr(*largs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K._launch_lr(*largs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [K._launch_lr(*largs)[0] for _ in range(2)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(out, eager) for out in outs)
    with torch.cuda.stream(side):
        again, _ = K._launch_lr(*largs)
    torch.cuda.synchronize()
    assert torch.equal(again, eager)


@pytest.mark.parametrize("rank,Kd,bits,M,path", [
    (320, 256, 4, 8, "tile"), (321, 256, 4, 8, "coop"),
    (320, 256, 4, 32, "tile"), (321, 256, 4, 32, "coop"),
    (16, 66304, 8, 8, "tile"), (16, 66320, 8, 8, "coop")])
def test_lr_tile_rules(dev, rank, Kd, bits, M, path):
    # the plan takes the tile path up to the rank (320, the L tile path's
    # ring) and K (66311, its i32 sums) it holds and the cooperative kernel
    # past them, at decode and prefill M: the public wrapper gives that
    # design's bits, within the bounds of test_lr_kernel_matches_plain; a
    # forced tile path past them raises
    d, largs = _lr_case(dev, 895 + M + rank, (64,), rank, M, bits, Kd)
    assert K._w4a8_lr_plan(M, 64, Kd, bits, rank, (64,))["path"] == path
    y = K.quantized_matmul_w4a8_lr_stacked(
        d["x"], d["packed"], d["scales"], 1, d["R"], d["Rs"], d["L"],
        d["Ls"], bits, rank, (64,))
    y_path, xr = K._launch_lr(*largs, path=path)
    assert torch.equal(y, y_path)
    xr_ref = K.thin_xr(d["x"], d["R"][1], d["Rs"][1])
    torch.testing.assert_close(xr, xr_ref, rtol=1e-5,
                               atol=1e-5 * float(xr_ref.abs().max()))
    ref = K.quantized_matmul_w4a8_l_stacked_plain(
        d["x"], d["packed"], d["scales"], 1, xr, d["L"], d["Ls"], bits, rank,
        (64,))
    torch.testing.assert_close(y, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    if path == "coop":
        with pytest.raises(ValueError, match="ranks" if rank > 320 else "i32"):
            K._launch_lr(*largs, path="tile")


def _mlp_inputs(rng, L, h, im, rank, bits, M):
    f = 8 // bits
    high = 255 if bits == 8 else 256
    u = rng.uniform
    t = torch.from_numpy
    x = t(rng.normal(size=(M, h)).astype(np.float32))
    w = [t(rng.integers(0, high, size=(L, 2 * im, h // f), dtype=np.uint8)),
         t(u(1e-3, 1e-2, (L, 2 * im, 1)).astype(np.float32))]
    gu_R = t(rng.integers(-127, 128, size=(L, 2 * rank, h), dtype=np.int8))
    gu_Rs = t(u(1e-4, 1e-3, (L, 2 * rank, 1)).astype(np.float32))
    rest = [t(rng.integers(-127, 128, size=(L, 2 * im, rank),
                           dtype=np.int8)),
            t(u(1e-4, 1e-3, (L, 2 * im, 1)).astype(np.float32)),
            t(u(0.5, 2.0, (L, 2)).astype(np.float32)),
            t(rng.integers(0, high, size=(L, h, im // f), dtype=np.uint8)),
            t(u(1e-3, 1e-2, (L, h, 1)).astype(np.float32)),
            t(rng.integers(-127, 128, size=(L, rank, im), dtype=np.int8)),
            t(u(1e-4, 1e-3, (L, rank, 1)).astype(np.float32)),
            t(rng.integers(-127, 128, size=(L, h, rank), dtype=np.int8)),
            t(u(1e-4, 1e-3, (L, h, 1)).astype(np.float32))]
    return x, w, gu_R, gu_Rs, rest


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [3, 8, 33, 128])
def test_mlp_kernel_matches_plain(dev, bits, M):
    # the kernel requantizes m inside: an f32 ulp of m (expf against
    # torch.sigmoid, the factor sums' order) can round one of its codes the
    # other way, so the bound is rel-Frobenius, not elementwise
    x, w, gu_R, gu_Rs, rest = _mlp_inputs(
        np.random.default_rng(900 + M + bits), 2, 256, 512, 128, bits, M)
    xr = K.thin_xr(x, gu_R[1], gu_Rs[1])
    ref = K.quantized_matmul_w4a8_mlp_stacked_plain(x, *w, 1, xr, *rest,
                                                    bits, 128)
    y = K.quantized_matmul_w4a8_mlp_stacked(
        x.to(dev), *(a.to(dev) for a in w), 1, xr.to(dev),
        *(a.to(dev) for a in rest), bits, 128)
    assert _rel(y, ref) <= 1e-3, _rel(y, ref)
    with pytest.raises(ValueError, match="one row block"):
        K.quantized_matmul_w4a8_mlp_stacked(
            torch.zeros((129, 256), device=dev), *(a.to(dev) for a in w), 1,
            torch.zeros((129, 256), device=dev), *(a.to(dev) for a in rest),
            bits, 128)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("B", [3, 8, 32])
def test_attn_o_kernel_matches_plain(dev, staged, B):
    # f32 attention in another summation order, then an int8 requant of the
    # attention inside the kernel (one code may round the other way)
    rng = np.random.default_rng(1000 + B)
    L, KVH, D, T, h, rank = 2, 4, 128, 64, 256, 128
    pos = torch.from_numpy(rng.integers(0, T, size=B).astype(np.int32))
    pos[0] = 0
    args = _decode_inputs(rng, L, B, KVH, 1, D, T)
    o = [torch.from_numpy(a) for a in (
        rng.integers(0, 256, size=(L, h, KVH * D // 2), dtype=np.uint8),
        rng.uniform(1e-3, 1e-2, (L, h, 1)).astype(np.float32),
        rng.integers(-127, 128, size=(L, rank, KVH * D), dtype=np.int8),
        rng.uniform(1e-4, 1e-3, (L, rank, 1)).astype(np.float32),
        rng.integers(-127, 128, size=(L, h, rank), dtype=np.int8),
        rng.uniform(1e-4, 1e-3, (L, h, 1)).astype(np.float32))]
    ref = AT.flash_decode_attn_o_plain(*args, 1, pos, *o, 4, rank,
                                       staged=staged, block_t=32)
    y = AT.flash_decode_attn_o(*(a.to(dev) for a in args), 1, pos.to(dev),
                               *(a.to(dev) for a in o), 4, rank,
                               staged=staged, block_t=32)
    assert _rel(y, ref) <= 1e-3, _rel(y, ref)


# Llama-2-7B widths of the two fusion kernels (csrc/fused_proj.cuh): the
# MLP (h 4096, im 11008) and attention + o_proj (32 heads of 128, o_proj
# 4096 x 4096), rank 128, weights on the card from a seeded generator
_FUSION_7B = {}


def _mlp_7b(dev, bits):
    if ("mlp", bits) not in _FUSION_7B:
        _FUSION_7B.clear()
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev)
        gen.manual_seed(1100 + bits)
        h, im, rank, L, f = 4096, 11008, 128, 2, 8 // bits

        def codes(*shape, lo=-127, hi=128, dtype=torch.int8):
            return torch.randint(lo, hi, shape, generator=gen, dtype=dtype,
                                 device=dev)

        def scales(*shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                               device=dev)
        w = [codes(L, 2 * im, h // f, lo=0, hi=256, dtype=torch.uint8),
             scales(L, 2 * im, 1, lo=1e-3, hi=1e-2)]
        gu_R = codes(L, 2 * rank, h)
        gu_Rs = scales(L, 2 * rank, 1, lo=1e-4, hi=1e-3)
        rest = [codes(L, 2 * im, rank), scales(L, 2 * im, 1, lo=1e-4, hi=1e-3),
                scales(L, 2, lo=0.5, hi=2.0),
                codes(L, h, im // f, lo=0, hi=256, dtype=torch.uint8),
                scales(L, h, 1, lo=1e-3, hi=1e-2), codes(L, rank, im),
                scales(L, rank, 1, lo=1e-4, hi=1e-3), codes(L, h, rank),
                scales(L, h, 1, lo=1e-4, hi=1e-3)]
        _FUSION_7B["mlp", bits] = (w, gu_R, gu_Rs, rest)
    return _FUSION_7B["mlp", bits]


def _mlp_7b_call(dev, bits, M, seed=0):
    """(launch(ctas), plain output) of the whole-MLP kernel at Llama-2-7B
    widths, layer 1, M rows."""
    w, gu_R, gu_Rs, rest = _mlp_7b(dev, bits)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1200 + M + seed)
    x = torch.randn((M, 4096), generator=gen, device=dev)
    xr = K.thin_xr(x, gu_R[1], gu_Rs[1])
    xq, sx = K.quantize_activations_int8(x)

    def launch(ctas=0):
        return K._launch_mlp(xq, sx, xr, *w, 1, *rest, bits, 128, ctas)[0]
    ref = K.quantized_matmul_w4a8_mlp_stacked_plain(x, *w, 1, xr, *rest,
                                                    bits, 128)
    return launch, ref


def _attn_o_7b_call(dev, B, staged, T=256):
    """(launch(ctas), plain output) of attention + o_proj at Llama-2-7B
    heads, layer 1, rows at seeded positions below T (row 0 at 0)."""
    rng = np.random.default_rng(1300 + B + T)
    L, KVH, D, h, rank = 2, 32, 128, 4096, 128
    pos = torch.from_numpy(rng.integers(0, T, size=B).astype(np.int32))
    pos[0] = 0
    args = [a.to(dev) for a in _decode_inputs(rng, L, B, KVH, 1, D, T)]
    o = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 256, size=(L, h, KVH * D // 2), dtype=np.uint8),
        rng.uniform(1e-3, 1e-2, (L, h, 1)).astype(np.float32),
        rng.integers(-127, 128, size=(L, rank, KVH * D), dtype=np.int8),
        rng.uniform(1e-4, 1e-3, (L, rank, 1)).astype(np.float32),
        rng.integers(-127, 128, size=(L, h, rank), dtype=np.int8),
        rng.uniform(1e-4, 1e-3, (L, h, 1)).astype(np.float32))]
    pos = pos.to(dev)

    def launch(ctas=0):
        return AT._launch_attn_o(*args, 1, pos, *o, 4, rank, staged, 256,
                                 ctas)[0]
    ref = AT.flash_decode_attn_o_plain(*args, 1, pos, *o, 4, rank,
                                       staged=staged)
    return launch, ref


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("M", [1, 8, 33, 128])
def test_mlp_kernel_7b_matches_plain(dev, bits, M):
    # the kernel's own requantization of m may round a code the other way
    # (the L dots' and xrd's sums run in other orders), hence the
    # rel-Frobenius bound of test_mlp_kernel_matches_plain
    launch, ref = _mlp_7b_call(dev, bits, M)
    assert _rel(launch(), ref) <= 1e-3, _rel(launch(), ref)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_attn_o_kernel_7b_matches_plain(dev, staged, B):
    launch, ref = _attn_o_7b_call(dev, B, staged)
    assert _rel(launch(), ref) <= 1e-3, _rel(launch(), ref)


@pytest.mark.parametrize("kernel", ["mlp M=8", "mlp M=33", "attn_o B=8"])
def test_fusion_kernels_repeat_graph_stream(dev, kernel):
    # a second launch, a CUDA-graph replay and a launch on a second stream
    # give the first launch's bits (fixed-order sums, counters left zeroed,
    # the counters of another stream and of a capture their own)
    launch, _ = (_attn_o_7b_call(dev, 8, True) if kernel.startswith("attn")
                 else _mlp_7b_call(dev, 4, int(kernel.split("=")[1])))
    first = launch()
    assert torch.equal(launch(), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = launch()
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(other, first)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launch()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


@pytest.mark.parametrize("kernel", ["mlp", "attn_o"])
@pytest.mark.parametrize("ctas", [1, 7])
def test_fusion_kernels_small_grid(dev, kernel, ctas):
    # a small grid cuts every stage over few warps (down to one CTA that
    # walks every slab); each group's integer sums are exact, its one L
    # slab's sum does not depend on the warp, and the folds and reduces
    # have fixed orders, so the outputs equal the full grid's bit for bit
    launch, ref = (_attn_o_7b_call(dev, 8, False) if kernel == "attn_o"
                   else _mlp_7b_call(dev, 4, 8, seed=1))
    full = launch()
    small = launch(ctas)
    assert torch.equal(small, full)
    assert _rel(small, ref) <= 1e-3


@pytest.mark.parametrize("flags", [
    dict(fk="l", staged_kv="uniform", attn_dots="i8"),
    dict(fk="lr", staged_kv="uniform", attn_dots="i8"),
    dict(fk="l", staged_kv=True, attn_dots="f32", mlp_kernel=True,
         attn_o_kernel=True),
    dict(fk="l", staged_kv=False, attn_dots="f32", mlp_kernel=True,
         attn_o_kernel=True)])
def test_factor_path_steps_on_card(dev, flags, monkeypatch):
    # the fused step's options on a 2-layer tiny-mha at rank 128: exact
    # launches per step, then the same steps with the plain versions on the
    # card (the same glue; an f32 ulp can flip one int8 code)
    flags = dict(flags)
    fk = flags.pop("fk")
    config = dataclasses.replace(TINY_MHA, num_layers=2)
    params = fused.quantize_factors_int8_fused(fused.fuse_stacked(
        bench_params.build_compressed_llama_params(config, rank=128, seed=0,
                                                   device=dev)),
        fuse_factor_kernel=fk)
    assert params.layers.qkv.L_cat is not None
    Lk = config.num_layers
    counters = (K.quantized_matmul_w4a8_l_stacked,
                K.quantized_matmul_w4a8_lr_stacked,
                K.quantized_matmul_w4a8_mlp_stacked, AT.flash_decode_attn_o,
                K.quantized_matmul_w4a8_stacked, K.int8_matmul)
    expect = {"l": [4 * Lk, 0, 0, 0, 0, 1], "lr": [0, 2 * Lk, 0, 0, 2 * Lk,
                                                   1]}[fk]
    if flags.get("mlp_kernel"):
        expect = [Lk, 0, Lk, Lk, 0, 1]
    B, T = 4, 16

    def run():
        cache = llama.HeadMajorQuantKVCache.create(config, B, T, device=dev)
        tokens = torch.tensor([1, 2, 3, 4], device=dev)
        out = []
        for step in range(3):
            pos = torch.full((B,), 5 + step, dtype=torch.int32, device=dev)
            before = [fn.launches for fn in counters]
            logits, cache = fused.decode_step_fused(params, tokens, pos,
                                                    cache, config, **flags)
            out.append(([fn.launches - b for fn, b in zip(counters, before)],
                        logits.cpu()))
            tokens = logits.argmax(-1)
        return out

    kern = run()
    assert all(launches == expect for launches, _ in kern)
    for name, plain in (
            ("quantized_matmul_w4a8_l_stacked",
             K.quantized_matmul_w4a8_l_stacked_plain),
            ("quantized_matmul_w4a8_lr_stacked",
             K.quantized_matmul_w4a8_lr_stacked_plain),
            ("quantized_matmul_w4a8_mlp_stacked",
             K.quantized_matmul_w4a8_mlp_stacked_plain),
            ("quantized_matmul_w4a8_stacked",
             K.quantized_matmul_w4a8_stacked_plain),
            ("int8_matmul", K.int8_matmul_plain)):
        monkeypatch.setattr(K, name, plain)
    monkeypatch.setattr(AT, "flash_decode_attn_o",
                        AT.flash_decode_attn_o_plain)
    monkeypatch.setattr(AT, "flash_decode_q8_staged",
                        AT.flash_decode_q8_staged_plain)
    monkeypatch.setattr(AT, "flash_decode_q8", AT.flash_decode_q8_plain)
    for (_, got), (_, ref) in zip(kern, run()):
        assert _rel(got, ref) <= 5e-3, _rel(got, ref)
        assert torch.equal(got.argmax(-1), ref.argmax(-1))


# ---------------------------------------------------------------------------
# The whole-step megakernel (csrc/megastep.cu)
# ---------------------------------------------------------------------------

_MEGA = {}


def _mega_params(dev, name, bits):
    """Factor path "l" params (rank 128) of TINY_MHA or a 2-layer
    Llama-2-7B width, with their interleaved gate/up set; built once."""
    if (name, bits) not in _MEGA:
        config = {"tiny-mha": TINY_MHA,
                  "7b-2l": dataclasses.replace(LLAMA2_7B, num_layers=2)}[name]
        params = fused.quantize_factors_int8_fused(fused.fuse_stacked(
            bench_params.build_compressed_llama_params(
                config, num_bits=bits, rank=128, seed=3, device=dev)),
            fuse_factor_kernel="l")
        _MEGA[name, bits] = (config, params,
                             persistent.prepare_gateup_interleaved(
                                 params.layers.gateup,
                                 config.intermediate_size))
    return _MEGA[name, bits]


def _mega_cache(dev, rng, config, B, T):
    shape = (config.num_layers, B, config.num_kv_heads, T, config.head_dim)
    codes = [torch.from_numpy(rng.integers(-127, 128, size=shape,
                                           dtype=np.int8)) for _ in range(2)]
    scales = [torch.from_numpy(rng.uniform(1e-3, 2e-2, shape[:4]).astype(
        np.float32)) for _ in range(2)]
    return llama.HeadMajorQuantKVCache(codes[0].to(dev), codes[1].to(dev),
                                       scales[0].to(dev), scales[1].to(dev))


# Kernel against its plain version on the card from the same operands. The
# integer sums are exact and every stage agrees with the plain one to a few
# f32 ulps when it is given the same inputs (test_megastep_stages_match_
# plain), but RMSNorm, the thin R dots and the attention sum in another
# order, so now and then a value on a rounding edge takes the other int8
# code and the flip carries through the rest of the step: one flipped code
# of the RMSNorm output moved its row's K codes (about 5% of them, by one)
# and, at 2 bits on random weights, that row's output by 4%. Readings over
# these cases: x_out rel-Frobenius up to 6.0e-3 (Llama-2-7B width, 2-bit,
# batch 8, ragged), K/V codes of layer 0 (whose inputs are the same) apart
# by at most one.
MEGA_X_REL = 2e-2
MEGA_STAGE_BF16 = 1e-3


def _mega_case(dev, name, bits, B, T, ragged, layers=None):
    """Operands of one megastep call: a seeded cache and tokens, uniform
    positions (128) or ragged ones with a row at 0 and one at T - 1."""
    config, params, prep = _mega_params(dev, name, bits)
    rng = np.random.default_rng(1100 + 7 * B + T + bits)
    cache = _mega_cache(dev, rng, config, B, T)
    pos = np.full(B, 128, np.int32)
    if ragged:
        pos = rng.integers(0, T, size=B).astype(np.int32)
        pos[0] = 0
        pos[-1] = T - 1 if B > 1 else 0
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, size=B))
    args, kw = persistent.megastep_operands(
        params, tokens.to(dev), torch.from_numpy(pos).to(dev), cache, config,
        prep)
    if layers is not None:       # a slice of the layer-stacked operands
        args = tuple(t if n in ("x0", "pos", "cos", "sin") else t[layers]
                     for n, t in zip(MS._OPERANDS, args))
    return args, kw


@pytest.mark.parametrize("name,bits,B,T,ragged", [
    *[("tiny-mha", bits, B, T, ragged) for bits in (2, 4) for B in (1, 8, 32)
      for T, ragged in ((256, False), (300, True))],
    *[("7b-2l", 4, B, T, ragged) for B in (1, 8, 32)
      for T, ragged in ((256, False), (300, True))],
    ("7b-2l", 2, 8, 256, True)])
def test_megastep_kernel_matches_plain(dev, name, bits, B, T, ragged):
    # the whole step, both layers: T = 300 is one 300-token block, walked in
    # 256-token sub-tiles; two launches give the same bits
    args, kw = _mega_case(dev, name, bits, B, T, ragged)
    before = MS.megastep.launches
    got = MS.megastep(*args, **kw)
    again = MS.megastep(*args, **kw)
    assert MS.megastep.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    ref = MS.megastep_plain(*args, **kw)
    assert bool(torch.isfinite(got[0]).all())
    assert _rel(got[0], ref[0]) <= MEGA_X_REL, _rel(got[0], ref[0])
    for g, r in ((got[1], ref[1]), (got[3], ref[3])):
        assert int((g[0].int() - r[0].int()).abs().max()) <= 1


@pytest.mark.parametrize("name,bits,B,T,ragged", [
    ("tiny-mha", 4, 8, 256, False), ("tiny-mha", 2, 32, 300, True),
    ("7b-2l", 2, 8, 256, True), ("7b-2l", 4, 32, 300, True)])
def test_megastep_stages_match_plain(dev, name, bits, B, T, ragged):
    # one layer; each stage's plain version is given the kernel's own
    # upstream values (its scratch), so no rounding flip upstream reaches
    # it: RoPE, the K/V codes and the m codes are exact; the attention and
    # the thin factor dots within a few f32 ulps. The residual after o_proj
    # and down (y, x) also carries the bf16 casts of xr_o and xrd before
    # their L dots, which can round to the other neighbour: one bf16
    # spacing is up to 2^-7 of the value (3.0e-4 read on a row of x), so
    # those take the factor paths' 1e-3. q/k/v from the step's own input
    # hold the RMSNorm flips.
    args, kw = _mega_case(dev, name, bits, B, T, ragged, layers=slice(0, 1))
    a = MS._named(args, **kw)
    (x, k8, ks8, v8, vs8), scr = MS._launch(a)
    rank = kw["rank"]
    r = MS._layer_plain(a, 0, a.x0.float(), feed=dict(
        qkv=scr["qkv"], ao=scr["ao"], y_mlp=scr["y"],
        sy_mlp=scr["sy"][:, None], xr_gu=scr["xr"][:B * 2 * rank].view(
            B, 2 * rank), m=scr["m"]))

    def rows(got, ref):
        return max(_rel(g, q) for g, q in zip(got, ref))
    assert rows(scr["qkv"], r["qkv"]) <= MEGA_X_REL
    assert torch.equal(scr["qrot"], r["qrot"])
    # the K/V scales absmax / 127: llama.quantize_kv's division by a Python
    # scalar runs on the card as a multiplication by its reciprocal, one f32
    # ulp from the kernel's division; a head whose scale is that ulp apart
    # may round a code on an edge the other way, the others are exact
    for codes, ref_codes, sc, ref_sc in ((k8[0], r["k8"], ks8[0], r["ks"]),
                                         (v8[0], r["v8"], vs8[0], r["vs"])):
        torch.testing.assert_close(sc, ref_sc, rtol=2.4e-7, atol=0)
        d = (codes.int() - ref_codes.int()).abs()
        assert int(d.max()) <= 1
        assert int(d[sc == ref_sc].sum()) == 0
    assert rows(scr["ao"], r["ao"]) <= 1e-5
    assert rows(scr["y"], r["y_mlp"]) <= MEGA_STAGE_BF16
    assert rows(scr["xr"][:B * 2 * rank].view(B, 2 * rank), r["xr_gu"]) <= \
        1e-5
    assert rows(scr["m"], r["m"]) <= 1e-5
    assert torch.equal(scr["a8"][:B * a.im].view(B, a.im), r["m8"])
    assert rows(scr["xrd"], r["xrd"]) <= 1e-5
    assert rows(x, r["x"]) <= MEGA_STAGE_BF16


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("layout,N,Kd,bng", [
    ("qkv", 384, 4096, 0),        # 32-row groups, 16 chunks a row
    ("down", 128, 11008, 0),      # a ragged last chunk at 2 bits
    ("gateup", 2 * 512, 1024, 256)])
def test_megastep_proj_sums_exact(dev, bits, B, layout, N, Kd, bng):
    # one projection stage of the megakernel alone (megastep_proj.cuh: the
    # TMA weight stream, mma.sync m16n8k32 on the signed codes, the split
    # groups' partial sums): its i32 sums equal the exact sums and the W4A8
    # kernel's (rowdot at B <= 8), on one CTA per SM and on 7 CTAs (other
    # splits), and leave every split counter at 0
    rng = np.random.default_rng(1500 + bits + B + N)
    f = 8 // bits
    x8 = torch.from_numpy(rng.integers(-127, 128, size=(B, Kd),
                                       dtype=np.int8)).to(dev)
    packed = torch.from_numpy(rng.integers(0, 256, size=(N, Kd // f),
                                           dtype=np.uint8)).to(dev)
    maxq = 2 ** (bits - 1) - 1
    codes = K.unpack_codes(packed, bits).double() - maxq
    exact = (codes @ x8.double().T).long()
    ref = K._launch_w4a8_stacked(
        x8, torch.ones((B, 1), device=dev), packed[None],
        torch.ones((1, N, 1), device=dev), 0, bits)
    assert torch.equal(ref.T.double(), exact.double())
    for ctas in (None, 7):
        got = MS._proj_sums(x8, packed, bits, bng=bng, ctas=ctas)
        assert torch.equal(got.long(), exact), (ctas, int(
            (got.long() - exact).abs().max()))


def test_megastep_streams_and_graph(dev):
    # launches on two streams at once and one captured in a CUDA graph give
    # the eager launch's bits (each call has its own scratch and counters)
    args, kw = _mega_case(dev, "7b-2l", 4, 8, 256, False)
    ref = MS.megastep(*args, **kw)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        out1 = MS.megastep(*args, **kw)
    with torch.cuda.stream(s2):
        out2 = MS.megastep(*args, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        MS.megastep(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out3 = MS.megastep(*args, **kw)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for out in (out1, out2, out3):
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


def test_megastep_guards(dev):
    # the reference's assert as a ValueError: batch 33, and a GQA layout
    # (the fused q/k/v rows are not 3 x KVH x D); decode_step_persistent
    # refuses a GQA model
    config, params, prep = _mega_params(dev, "tiny-mha", 4)
    rng = np.random.default_rng(1200)
    for B, kvhd in ((33, None), (2, (2, config.head_dim))):
        cache = _mega_cache(dev, rng, config, B, 128)
        args, kw = persistent.megastep_operands(
            params, torch.zeros(B, dtype=torch.int64, device=dev),
            torch.full((B,), 3, dtype=torch.int32, device=dev), cache, config,
            prep)
        if kvhd is not None:
            kw["kvhd"] = kvhd
        with pytest.raises(ValueError, match="megastep constraints"):
            MS.megastep(*args, **kw)
    gqa = fused.quantize_factors_int8_fused(fused.fuse_stacked(
        bench_params.build_compressed_llama_params(TINY, rank=128, seed=0,
                                                   device=dev)),
        fuse_factor_kernel="l")
    assert not persistent.persistent_supported(gqa, TINY)
    with pytest.raises(ValueError, match="not supported"):
        persistent.decode_step_persistent(
            gqa, torch.zeros(2, dtype=torch.int64, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev),
            llama.HeadMajorQuantKVCache.create(TINY, 2, 16, device=dev), TINY)


_ALL_KERNELS = (
    (K, "quantized_matmul"), (K, "quantized_matmul_w4a8"),
    (K, "quantized_matmul_w4a8_stacked"),
    (K, "quantized_matmul_w4a8_stacked_persistent"), (K, "int8_matmul"),
    (K, "bf16_matmul_stacked"), (K, "quantized_matmul_w4a8_l_stacked"),
    (K, "quantized_matmul_w4a8_lr_stacked"),
    (K, "quantized_matmul_w4a8_mlp_stacked"),
    (AT, "flash_decode_q8_staged"), (AT, "flash_decode_q8"),
    (AT, "flash_decode_q8_ab"), (AT, "flash_decode_q8_paged"),
    (AT, "flash_decode_attn_o"), (AT, "flash_prefill"), (MS, "megastep"))


@pytest.mark.parametrize("staged_kv", ["uniform", "on"])
def test_megastep_persistent_step_on_card(dev, staged_kv, monkeypatch):
    # three steps of decode_step_persistent at batch 8 (uniform positions,
    # or ragged ones with a row at 0): one megastep and one int8 head launch
    # per step and no other kernel; then the same steps, fed the same tokens,
    # through the plain versions on the card
    config, params, prep = _mega_params(dev, "tiny-mha", 4)
    B, T = 8, 256
    start = (np.full(B, 40) if staged_kv == "uniform"
             else np.asarray([0, 3, 17, 40, 99, 128, 200, 250]))

    counters = [getattr(m, n) for m, n in _ALL_KERNELS]

    def run(feed):
        cache = _mega_cache(dev, np.random.default_rng(1300), config, B, T)
        out = []
        for step, tokens in enumerate(feed):
            pos = torch.from_numpy((start + step).astype(np.int32)).to(dev)
            before = [c.launches for c in counters]
            logits, cache = persistent.decode_step_persistent(
                params, tokens, pos, cache, config, staged_kv=staged_kv,
                prep=prep)
            out.append(([c.launches - b for c, b in zip(counters, before)],
                        logits.cpu()))
            if len(feed) < 3:      # greedy: the next step's tokens
                feed.append(logits.argmax(-1))
        return out, cache

    feed = [torch.arange(1, B + 1, device=dev)]
    kern, ckern = run(feed)
    expect = [1 if n in ("int8_matmul", "megastep") else 0
              for _, n in _ALL_KERNELS]
    assert all(launches == expect for launches, _ in kern)
    monkeypatch.setattr(MS, "megastep", MS.megastep_plain)
    monkeypatch.setattr(K, "int8_matmul", K.int8_matmul_plain)
    plain, cplain = run(feed)
    for (_, got), (_, ref) in zip(kern, plain):
        assert _rel(got, ref) <= MEGA_X_REL, _rel(got, ref)
    for name in ("k", "v"):
        # the first layer's committed codes at most one apart (a flip)
        d = (getattr(ckern, name)[0].int() - getattr(cplain, name)[0].int())
        assert int(d.abs().max()) <= 1


# ---------------------------------------------------------------------------
# The compression pipeline on the card against the CPU port
# ---------------------------------------------------------------------------

def _compress_inputs(seed, m=512, n=1376):
    """A seeded weight and a correlated, well-conditioned second moment
    (4n samples of z (I + 0.3 G / sqrt(n)))."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((m, n)).astype(np.float32)
    X = rng.standard_normal((4 * n, n)).astype(np.float32)
    X = X @ (np.eye(n, dtype=np.float32)
             + 0.3 * rng.standard_normal((n, n)).astype(np.float32)
             / np.sqrt(n))
    return torch.from_numpy(W), torch.from_numpy(
        (X.T @ X / (4 * n)).astype(np.float32))


def _aa_error(W, W_hat, H):
    E = (W_hat - W).double()
    W, H = W.double(), H.double()
    return float(torch.sqrt(((E @ H) * E).sum() / ((W @ H) * W).sum()))


@pytest.mark.parametrize("q_update", ["rtn", "ldlq"])
def test_caldera_on_card_matches_cpu(dev, q_update):
    from ee274_convexcaldera_llm_quantization_tpu_torch.decomp import (
        caldera as C)
    W, H = _compress_inputs(900)
    p = C.CalderaParams(Q_bits=4, L_bits=16, R_bits=16, rank=32, iters=2,
                        q_update=q_update)
    cpu = C.caldera(p, W, H, scale_W=False)
    card = C.caldera(p, W.to(dev), H.to(dev), scale_W=False)
    assert card.Q.device.type == "cuda"
    e_cpu = _aa_error(W, cpu.reconstruct(), H)
    e_card = _aa_error(W, card.reconstruct().cpu(), H)
    # cuSOLVER against LAPACK (SVD, eigh, Cholesky) and another sum order:
    # the same codes up to rounding edges, and under LDLQ a few edge flips
    # that the feedback carries on; 2% of the error (as between panel
    # widths in the reference's tests)
    assert abs(e_card - e_cpu) <= 0.02 * e_cpu, (e_card, e_cpu)


@pytest.mark.parametrize("bits", [2, 4])
def test_ldlq_sweep_on_card_matches_cpu(dev, bits):
    from ee274_convexcaldera_llm_quantization_tpu_torch.decomp import (
        caldera as C)
    W, H = _compress_inputs(901)
    U = C.ldlq_precompute(H)
    cpu = C.ldlq_quantize(W, U, bits)
    card = C.ldlq_quantize(W.to(dev), U.to(dev), bits).cpu()
    maxq = 2 ** (bits - 1) - 1
    scale = W.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / maxq
    same = torch.round(card / scale) == torch.round(cpu / scale)
    # one f32 rounding per column and per panel update on each side: the
    # codes agree but where a column's input sits on an edge and the
    # feedback carries the flip along its row
    assert float(same.float().mean()) >= 0.99
    e_cpu, e_card = _aa_error(W, cpu, H), _aa_error(W, card, H)
    assert abs(e_card - e_cpu) <= 0.02 * e_cpu
    U_card = C.ldlq_precompute(H.to(dev)).cpu()
    torch.testing.assert_close(U_card, U, rtol=0,
                               atol=1e-4 * float(U.abs().max()))


def test_e8p_encode_on_card_matches_cpu(dev):
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import lattice
    rng = np.random.default_rng(902)
    y = torch.from_numpy((1.5 * rng.standard_normal((65536, 8)))
                         .astype(np.float32))
    cb = lattice.codebook_on("cpu")
    cpu = lattice.e8p_encode(y, cb)
    card = lattice.e8p_encode(y.to(dev), lattice.codebook_on(dev)).cpu()
    diff = card != cpu
    d = lambda idx: ((y - cb[idx.long()]) ** 2).sum(dim=1)  # noqa: E731
    # an index differs only at a near tie of the two codewords' distances
    torch.testing.assert_close(d(card)[diff], d(cpu)[diff], rtol=1e-5,
                               atol=1e-5)
    assert float(diff.float().mean()) <= 1e-3
    # the int4 repack of per-row blocks: bytes from the same codes
    W = torch.from_numpy(rng.standard_normal((64, 4096)).astype(np.float32))
    p_cpu, h_cpu, _ = lattice.e8p_pack_rowscale(W)
    p_card, h_card, _ = lattice.e8p_pack_rowscale(W.to(dev))
    same = (p_card.cpu() == p_cpu).float().mean()
    assert float(same) >= 0.999
    torch.testing.assert_close(h_card.cpu(), h_cpu, rtol=1e-6, atol=0)


def test_rotated_linear_on_card_matches_plain(dev, monkeypatch):
    # a RotatedLinear's inner flat W4A8 linear on Hadamard-rotated
    # activations (both sides rotated, 4-bit), against the plain version on
    # the same card
    from ee274_convexcaldera_llm_quantization_tpu_torch.decomp.caldera import (
        CalderaParams)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        compressed as CM, surgery)
    g = torch.Generator(device=dev).manual_seed(1500)
    W = torch.randn((512, 1024), generator=g, device=dev) / 32
    cp = CalderaParams(Q_bits=4, L_bits=16, R_bits=16, rank=16, iters=1,
                       lplr_iters=1)
    rl, err = surgery.compress_linear_rotated(cp, W, serving_mode="w4a8")
    assert (rl.rot_in, rl.rot_out) == (True, True) and err < 0.2
    xs = [torch.randn((M, 1024), generator=g, device=dev) for M in (1, 8, 64)]
    before = K.quantized_matmul_w4a8.launches
    ys = [CM.apply_linear(rl, x) for x in xs]
    assert K.quantized_matmul_w4a8.launches == before + len(xs)
    monkeypatch.setattr(K, "quantized_matmul_w4a8",
                        K.quantized_matmul_w4a8_plain)
    for x, y in zip(xs, ys):
        _close(y, CM.apply_linear(rl, x))


def test_budget_layer_w4a8_bits_on_card(dev, monkeypatch):
    # compress_model_with_budget on one TINY-MHA layer with a (2, 8) menu:
    # every projection served by the flat W4A8 kernel at its 2- or 8-bit
    # width, against the plain version on the card
    from ee274_convexcaldera_llm_quantization_tpu_torch.decomp.caldera import (
        CalderaParams)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        compressed as CM, surgery)
    config = dataclasses.replace(TINY_MHA, num_layers=1)
    params = llama.init_params(1501, config, device=dev)
    cp = CalderaParams(Q_bits=4, L_bits=16, R_bits=16, rank=8, iters=1,
                       lplr_iters=1)
    q, report, alloc = surgery.compress_model_with_budget(
        params, cp, 5.0, menu=(2, 8), serving_mode="w4a8")
    assert set(alloc.bits.values()) == {2.0, 8.0}, alloc.bits
    g = torch.Generator(device=dev).manual_seed(1502)
    lins = [getattr(q.layers[0], name) for name in surgery.PROJ_NAMES]
    assert [lin.num_bits for lin in lins] == [
        alloc.bits[f"layers.0.{name}"] for name in surgery.PROJ_NAMES]
    xs = [torch.randn((8, lin.in_features), generator=g, device=dev)
          for lin in lins]
    ys = [CM.apply_linear(lin, x) for lin, x in zip(lins, xs)]
    monkeypatch.setattr(K, "quantized_matmul_w4a8",
                        K.quantized_matmul_w4a8_plain)
    for lin, x, y in zip(lins, xs, ys):
        _close(y, CM.apply_linear(lin, x))
