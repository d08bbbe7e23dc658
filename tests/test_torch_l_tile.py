"""The L-fused W4A8 kernel's tile path on the CPU: the plan that picks it
(``ops/kernels.py::_w4a8_l_plan``) and a plain model of its walk.

Above the decode threshold ``csrc/w4a8_lowrank.cu`` runs
``quantized_matmul_w4a8_l_stacked`` on the int8 ``wgmma`` tile kernel of
``csrc/w4a8_tile.cuh`` (the walk of ``tests/test_torch_w4a8_tile.py``) with
an L epilogue: after a tile's int8 sub-steps, one sub-step per (projection
the tile's 128 weight rows touch, 64 ranks) holds the tile's xr window
rounded to bf16 as A and the tile's L codes as bf16 as B (TMA boxes, zero
past N, M and the rank), and bf16 ``wgmma`` k16 slices sum them into an f32
accumulator, one pass per projection; each output adds the pass of its own
projection: ``base + ylr * Ls``, rounded one operation at a time. The model
below does that with numpy: its integer half must equal the plain version's
bit for bit, and its output the plain version's within the card tests'
bound (the factor sums run in another f32 order).
"""

import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

from test_torch_w4a8_tile import _tile_walk

# the card tests' bound on the L-fused kernel (tests/test_torch_cuda.py)
RTOL, ATOL_REL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _l_walk(xr, L, rank, splits, N, plan, M):
    """ylr of the tile kernel's L epilogue: xr (M, n_proj * rank) f32, L (N,
    rank) int8, as numpy arrays; f32 sums of one k16 slice at a time."""
    ends = K._split_bounds(splits, N)
    proj = np.array([sum(n >= b for b in ends) for n in range(N)])
    rows, cols, lk = plan["rows"], plan["cols"], K._L_TILE_RANKS
    ylr = np.zeros((M, N), np.float32)
    steps = 0
    for m0 in range(0, M, rows):
        mv = min(rows, M - m0)
        for ti, n0 in enumerate(range(0, N, cols)):
            nv = min(cols, N - n0)
            p0, p1 = plan["windows"][ti]
            for p in range(p0, p1 + 1):
                acc = np.zeros((rows, cols), np.float32)
                for c in range(plan["chunks"]):
                    r0, r1 = lk * c, min(lk * (c + 1), rank)
                    a = np.zeros((rows, lk), np.float32)
                    a[:mv, :r1 - r0] = _bf16(
                        xr[m0:m0 + mv, p * rank + r0:p * rank + r1])
                    b = np.zeros((cols, lk), np.float32)
                    b[:nv, :r1 - r0] = L[n0:n0 + nv, r0:r1]
                    for kk in range(lk // 16):
                        s = slice(16 * kk, 16 * kk + 16)
                        acc = (acc + a[:, s] @ b[:, s].T).astype(np.float32)
                    steps += 1
                mine = np.flatnonzero(proj[n0:n0 + nv] == p)
                ylr[m0:m0 + mv, n0 + mine] = acc[:mv, mine]
    assert steps == -(-M // rows) * sum(plan["l_steps"])
    return ylr


def _group(seed, M, splits, Kd, rank, bits, layers=2):
    rng = np.random.default_rng(seed)
    f = 8 // bits
    N, nR = sum(splits), len(splits) * rank
    return dict(
        x=torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32)),
        packed=torch.from_numpy(rng.integers(
            0, 256, size=(layers, N, Kd // f), dtype=np.uint8)),
        scales=torch.from_numpy(rng.uniform(
            1e-3, 1e-2, size=(layers, N, 1)).astype(np.float32)),
        xr=torch.from_numpy(rng.normal(
            scale=0.5, size=(M, nR)).astype(np.float32)),
        L=torch.from_numpy(rng.integers(
            -127, 128, size=(layers, N, rank), dtype=np.int8)),
        Ls=torch.from_numpy(rng.uniform(
            1e-4, 1e-3, size=(layers, N, 1)).astype(np.float32)))


# splits whose 128-row tiles straddle three projections, Llama-2-7B's qkv
# cut to width (never straddles), and one projection of rank 24 (one
# sub-step of 64 ranks, zero past 24) or 130 (three, the last zero past 2)
_SPLITS = [((40, 24, 136), 128), ((128, 128, 128), 64), ((96,), 24),
           ((200,), 130)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("splits,rank", _SPLITS)
def test_l_walk_matches_plain(splits, rank, rows, bits):
    M, Kd = 70, 512
    g = _group(3000 + rank + rows + bits, M, splits, Kd, rank, bits)
    N = sum(splits)
    plan = K._w4a8_l_plan(M, N, Kd, bits, rank, splits, path="tile",
                          rows=rows)
    xq, sx = K.quantize_activations_int8(g["x"])
    base = _tile_walk(xq.numpy(), sx.numpy(), g["packed"][1].numpy(),
                      g["scales"][1].numpy(), bits, plan)
    args = (g["packed"], g["scales"], 1, g["xr"])
    tail = (g["Ls"], bits, rank, splits)
    # the integer half: the plain version with the factors zeroed, bit for
    # bit
    zero = K.quantized_matmul_w4a8_l_stacked_plain(
        g["x"], *args, torch.zeros_like(g["L"]), *tail)
    assert np.array_equal(base, zero.numpy())
    ylr = _l_walk(g["xr"].numpy(), g["L"][1].numpy(), rank, splits, N, plan,
                  M)
    got = base + ylr * g["Ls"][1, :, 0].numpy()[None, :]
    ref = K.quantized_matmul_w4a8_l_stacked_plain(
        g["x"], *args, g["L"], *tail).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())


@pytest.mark.parametrize("M,path,rows", [
    (1, "rowdot", 8), (8, "rowdot", 8), (9, "tile", 64), (64, "tile", 64),
    (65, "tile", 128), (512, "tile", 128), (2048, "tile", 128)])
def test_plan_threshold_and_tiles(M, path, rows):
    # decode (M <= 8) keeps l_kernel; above, the tile kernel on row 3's
    # threshold and tile rule
    splits = (4096,) * 3
    plan = K._w4a8_l_plan(M, 12288, 4096, 4, 128, splits)
    assert (plan["path"], plan["rows"]) == (path, rows)
    w4a8 = K._w4a8_plan(M, 12288, 4096, 4)
    assert {k: plan[k] for k in w4a8} == w4a8
    if path == "tile":
        assert plan["tiles"] == (-(-M // rows), 96)
        # Llama-2-7B's splits are multiples of 128: one projection a tile
        assert plan["windows"] == tuple((n // 32, n // 32) for n in range(96))
        assert plan["l_steps"] == (2,) * 96
    else:
        assert "windows" not in plan


@pytest.mark.parametrize("rank,pad,chunks", [
    (8, 64, 1), (16, 64, 1), (24, 64, 1), (64, 64, 1), (65, 128, 2),
    (128, 128, 2), (130, 192, 3), (256, 256, 4)])
def test_plan_rank_padding(rank, pad, chunks):
    plan = K._w4a8_l_plan(512, 4096, 4096, 4, rank, (4096,))
    assert (plan["rank_pad"], plan["chunks"]) == (pad, chunks)
    assert plan["l_steps"] == (chunks,) * 32


@pytest.mark.parametrize("splits,windows", [
    ((40, 24, 136), ((0, 2), (2, 2))),
    ((100, 100, 100, 100), ((0, 1), (1, 2), (2, 3), (3, 3))),
    ((128, 256), ((0, 0), (1, 1), (1, 1))),
    ((11008, 11008), ((0, 0),) * 86 + ((1, 1),) * 86),
    ((11000, 11016), ((0, 0),) * 85 + ((0, 1),) + ((1, 1),) * 86)])
def test_plan_straddling_windows(splits, windows):
    # a 128-row tile takes one L pass per projection it touches
    plan = K._w4a8_l_plan(100, sum(splits), 1024, 4, 128, splits)
    assert plan["windows"] == windows
    assert plan["l_steps"] == tuple(2 * (b - a + 1) for a, b in windows)


@pytest.mark.parametrize("M,rank,rows", [
    (64, 192, 64), (64, 193, 128), (64, 320, 128), (512, 320, 128),
    (9, 256, 128)])
def test_plan_rank_fits_the_ring(M, rank, rows):
    # the consumers hold a window's 64-rank sub-steps at once: three fit
    # the ring at 64 rows a tile, five at 128
    plan = K._w4a8_l_plan(M, 4096, 4096, 4, rank, (4096,))
    assert plan["rows"] == rows


def test_plan_rank_over_the_ring_raises():
    with pytest.raises(ValueError, match="ranks"):
        K._w4a8_l_plan(512, 4096, 4096, 4, 321, (4096,))
    with pytest.raises(ValueError, match="ranks"):
        K._w4a8_l_plan(64, 4096, 4096, 4, 256, (4096,), rows=64)
    # decode keeps l_kernel at any rank
    assert K._w4a8_l_plan(8, 4096, 4096, 4, 512, (4096,))["path"] == "rowdot"


def test_plan_overrides_and_k_overflow():
    splits = (4096,)
    assert K._w4a8_l_plan(512, 4096, 4096, 4, 128, splits,
                          path="rowdot")["rows"] == 32
    assert K._w4a8_l_plan(8, 4096, 4096, 4, 128, splits,
                          path="tile")["rows"] == 64
    assert K._w4a8_l_plan(512, 4096, 4096, 4, 128, splits,
                          rows=64)["tiles"] == (8, 32)
    with pytest.raises(ValueError, match="i32"):
        K._w4a8_l_plan(512, 256, 66320, 8, 16, (256,))
    # decode keeps l_kernel at any K
    assert K._w4a8_l_plan(8, 256, 66320, 8, 16, (256,))["path"] == "rowdot"
    with pytest.raises(ValueError, match="64 or 128"):
        K._w4a8_l_plan(512, 4096, 4096, 4, 128, splits, rows=32)


def test_cpu_tensors_run_the_plain_version():
    # the plan is the card's: CPU tensors at prefill M run the plain version
    g = _group(3100, 40, (64,), 512, 16, 4)
    args = (g["x"], g["packed"], g["scales"], 0, g["xr"], g["L"], g["Ls"], 4,
            16, (64,))
    before = K.quantized_matmul_w4a8_l_stacked.launches
    y = K.quantized_matmul_w4a8_l_stacked(*args)
    assert K.quantized_matmul_w4a8_l_stacked.launches == before
    assert torch.equal(y, K.quantized_matmul_w4a8_l_stacked_plain(*args))
