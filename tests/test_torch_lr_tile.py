"""The LR-fused W4A8 kernel's tile path on the CPU: the plan that picks it
(``ops/kernels.py::_w4a8_lr_plan``) and a plain model of its ``xr`` kernel.

Above the decode threshold ``csrc/w4a8_lowrank.cu`` runs
``quantized_matmul_w4a8_lr_stacked`` as two launches: ``xr_kernel``
computes ``xr = (bf16(x) @ R[l].T) * Rs[l]`` on bf16 ``wgmma`` (tiles of 128
R rows and 16, 64 or 128 activation rows, TMA boxes zero past nR, M and K;
K in steps of 64 split across CTAs; blocks of four steps chained on a fresh
f32 accumulator, each added to the running sum, the splits' partial tiles
summed in split order, then one multiply by Rs), and the L-fused tile kernel
(``tests/test_torch_l_tile.py``) runs on that ``xr``. The model below does
that with numpy: its ``xr`` must match the plain thin dot, and, composed
with the tile walk and its L epilogue, its output the plain version on the
model's own ``xr``, within the card tests' bounds (an ``xr`` element that
rounds to the other bf16 neighbour before the L dot moves outputs by more,
so the output is held on its own ``xr``, as on the card).
"""

import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

from test_torch_l_tile import _bf16, _l_walk
from test_torch_w4a8_tile import _tile_walk

# the card tests' bound on the LR-fused kernel and its xr
# (tests/test_torch_cuda.py)
RTOL, ATOL_REL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xr_walk(x, R, Rs, plan):
    """xr_kernel's arithmetic: x (M, K) f32, R (nR, K) int8, Rs (nR, 1) f32,
    as numpy arrays, on an :func:`K._xr_plan`; f32 sums of one k16 slice at
    a time, a fresh accumulator every block of steps."""
    M, Kd = x.shape
    nR = R.shape[0]
    rows, cols, bk = K._XR_ROWS, plan["cols"], K._XR_BK
    blk, k_steps, ss = K._XR_BLOCK_STEPS, -(-Kd // bk), plan["split_steps"]
    xb = _bf16(x)
    out = np.empty((M, nR), np.float32)
    ctas = 0
    for m0 in range(0, M, cols):
        mv = min(cols, M - m0)
        for n0 in range(0, nR, rows):
            nv = min(rows, nR - n0)
            total = np.zeros((rows, cols), np.float32)
            for sp in range(plan["splits"]):
                run = np.zeros((rows, cols), np.float32)
                walk = range(sp * ss, min((sp + 1) * ss, k_steps))
                for j, i in enumerate(walk):
                    if j % blk == 0:
                        acc = np.zeros((rows, cols), np.float32)
                    k0 = i * bk
                    a = np.zeros((rows, bk), np.float32)
                    kv = min(bk, Kd - k0)
                    a[:nv, :kv] = R[n0:n0 + nv, k0:k0 + kv]
                    b = np.zeros((cols, bk), np.float32)
                    b[:mv, :kv] = xb[m0:m0 + mv, k0:k0 + kv]
                    for kk in range(bk // 16):
                        s = slice(16 * kk, 16 * kk + 16)
                        acc = (acc + a[:, s] @ b[:, s].T).astype(np.float32)
                    if j % blk == blk - 1 or j == len(walk) - 1:
                        run = (run + acc).astype(np.float32)
                total = (total + run).astype(np.float32)
                ctas += 1
            out[m0:m0 + mv, n0:n0 + nv] = (
                total[:nv, :mv].T * Rs[n0:n0 + nv, 0][None, :]).astype(
                    np.float32)
    assert ctas == plan["tiles"] * plan["splits"]
    return out


def _group(seed, M, splits, Kd, rank, bits, layers=2):
    rng = np.random.default_rng(seed)
    f = 8 // bits
    N, nR = sum(splits), len(splits) * rank
    t = torch.from_numpy
    return dict(
        x=t(rng.normal(size=(M, Kd)).astype(np.float32)),
        packed=t(rng.integers(0, 256, size=(layers, N, Kd // f),
                              dtype=np.uint8)),
        scales=t(rng.uniform(1e-3, 1e-2, size=(layers, N, 1))
                 .astype(np.float32)),
        R=t(rng.integers(-127, 128, size=(layers, nR, Kd), dtype=np.int8)),
        Rs=t(rng.uniform(1e-4, 1e-3, size=(layers, nR, 1))
             .astype(np.float32)),
        L=t(rng.integers(-127, 128, size=(layers, N, rank), dtype=np.int8)),
        Ls=t(rng.uniform(1e-4, 1e-3, size=(layers, N, 1))
             .astype(np.float32)))


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())


# (xr tile columns, steps a split) of K 576 = 9 steps: the plan's two
# splits of 5 and 4 steps (blocks of 4 and 1, then 4); three of 4, 4 and 1;
# nine of one
_XR_WALKS = [(128, None), (64, 4), (16, 1)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("rank", [24, 128, 130])
@pytest.mark.parametrize("xr_cols,xr_split_steps", _XR_WALKS)
def test_lr_walk_matches_plain(rank, bits, xr_cols, xr_split_steps):
    # splits whose 128-row weight tiles straddle three projections; at rank
    # 130 the xr kernel's 128-row R tiles straddle projections too (390
    # rows: four tiles, the last of 6 rows)
    splits, M, Kd = (40, 24, 136), 70, 576
    g = _group(5000 + rank + bits + xr_cols, M, splits, Kd, rank, bits)
    N = sum(splits)
    plan = K._w4a8_lr_plan(M, N, Kd, bits, rank, splits, path="tile",
                           xr_cols=xr_cols, xr_split_steps=xr_split_steps)
    assert plan["xr"]["cols"] == xr_cols
    xr = _xr_walk(g["x"].numpy(), g["R"][1].numpy(), g["Rs"][1].numpy(),
                  plan["xr"])
    _close(xr, K.thin_xr(g["x"], g["R"][1], g["Rs"][1]).numpy())
    xq, sx = K.quantize_activations_int8(g["x"])
    base = _tile_walk(xq.numpy(), sx.numpy(), g["packed"][1].numpy(),
                      g["scales"][1].numpy(), bits, plan)
    ylr = _l_walk(xr, g["L"][1].numpy(), rank, splits, N, plan, M)
    got = base + ylr * g["Ls"][1, :, 0].numpy()[None, :]
    ref = K.quantized_matmul_w4a8_l_stacked_plain(
        g["x"], g["packed"], g["scales"], 1, torch.from_numpy(xr), g["L"],
        g["Ls"], bits, rank, splits).numpy()
    _close(got, ref)


# Llama-2-7B's qkv (nR 384) and gate/up (nR 256) at rank 128, K 4096 (64
# steps), 132 SMs: (M, L tile rows, xr cols, xr tiles, splits, steps)
@pytest.mark.parametrize("n_proj,M,rows,cols,tiles,splits,steps", [
    (3, 1, 64, 16, 3, 16, 4),
    (3, 8, 64, 16, 3, 16, 4),
    (3, 9, 64, 16, 3, 16, 4),
    (3, 64, 64, 16, 12, 11, 6),
    (3, 65, 128, 16, 15, 8, 8),
    (3, 128, 128, 16, 24, 5, 13),
    (3, 129, 128, 64, 9, 13, 5),
    (3, 512, 128, 64, 24, 5, 13),
    (3, 1025, 128, 128, 27, 4, 16),
    (3, 2048, 128, 128, 48, 2, 32),
    (2, 8, 64, 16, 2, 16, 4),
    (2, 512, 128, 64, 16, 8, 8),
    (2, 2048, 128, 128, 32, 4, 16)])
def test_plan_tiles_and_splits(n_proj, M, rows, cols, tiles, splits, steps):
    # the xr kernel and the L tile path at every M (decode too): the tile
    # path beat the cooperative lr_kernel at every M measured; the L tile
    # path on row 6's plan
    sp = (4096,) * 3 if n_proj == 3 else (11008,) * 2
    N = sum(sp)
    plan = K._w4a8_lr_plan(M, N, 4096, 4, 128, sp)
    assert (plan["path"], plan["rows"]) == ("tile", rows)
    lplan = K._w4a8_l_plan(M, N, 4096, 4, 128, sp, path="tile")
    assert {k: plan[k] for k in lplan} == lplan
    xp = plan["xr"]
    assert (xp["cols"], xp["tiles"], xp["splits"], xp["split_steps"]) == (
        cols, tiles, splits, steps)
    assert xp["grid"] == (n_proj, -(-M // cols), splits)
    # every split walks at least four steps, none is empty, and the grid
    # stays within one CTA an SM
    assert (splits - 1) * steps < 64 <= splits * steps
    assert steps >= 4 and tiles * splits <= 132
    assert xp["workspace"] == (splits * tiles * 128 * cols if splits > 1
                               else 0)


@pytest.mark.parametrize("K_,steps,splits", [
    (16, 1, 1), (64, 1, 1), (100, 2, 1), (576, 5, 2), (4096, 4, 16),
    (11008, 4, 43)])
def test_xr_plan_splits_and_ragged_k(K_, steps, splits):
    # K in 64-k steps, the last possibly ragged (TMA zero-fills past K);
    # three tiles of nR 384 at M 9 want 44 splits, of at least 4 steps
    plan = K._xr_plan(9, 384, K_, 132)
    assert (plan["split_steps"], plan["splits"]) == (steps, splits)
    assert plan["grid"] == (3, 1, splits)


def test_plan_overrides():
    sp = (4096,) * 3
    # the cooperative kernel at any M, by override
    assert K._w4a8_lr_plan(512, 12288, 4096, 4, 128, sp,
                           path="coop") == dict(path="coop", rows=32)
    assert K._w4a8_lr_plan(8, 12288, 4096, 4, 128, sp,
                           path="coop") == dict(path="coop", rows=8)
    assert K._w4a8_lr_plan(8, 12288, 4096, 4, 128, sp,
                           path="tile") == K._w4a8_lr_plan(
        8, 12288, 4096, 4, 128, sp)
    assert K._w4a8_lr_plan(512, 12288, 4096, 4, 128, sp,
                           rows=64)["tiles"] == (8, 96)
    xp = K._w4a8_lr_plan(512, 12288, 4096, 4, 128, sp, xr_cols=128,
                         xr_split_steps=5)["xr"]
    assert (xp["cols"], xp["tiles"], xp["splits"], xp["split_steps"]) == (
        128, 12, 13, 5)
    with pytest.raises(ValueError, match="16, 64 or 128"):
        K._w4a8_lr_plan(512, 12288, 4096, 4, 128, sp, xr_cols=32)
    with pytest.raises(ValueError, match="LR-fused path"):
        K._w4a8_lr_plan(512, 12288, 4096, 4, 128, sp, path="rowdot")


@pytest.mark.parametrize("rank,pad,chunks", [
    (24, 64, 1), (128, 128, 2), (130, 192, 3)])
def test_plan_rank_padding(rank, pad, chunks):
    # the L epilogue's 64-rank sub-steps, zero past the rank; the xr
    # kernel's R rows are n_proj * rank, unpadded
    sp = (512, 256, 256)
    plan = K._w4a8_lr_plan(300, 1024, 512, 4, rank, sp)
    assert (plan["rank_pad"], plan["chunks"]) == (pad, chunks)
    assert plan["xr"]["tiles"] == -(-3 * rank // 128) * 5  # 64-row x tiles


@pytest.mark.parametrize("splits,windows", [
    ((40, 24, 136), ((0, 2), (2, 2))),
    ((11000, 11016), ((0, 0),) * 85 + ((0, 1),) + ((1, 1),) * 86)])
def test_plan_straddling_windows(splits, windows):
    plan = K._w4a8_lr_plan(100, sum(splits), 1024, 4, 128, splits)
    assert plan["windows"] == windows
    assert plan["l_steps"] == tuple(2 * (b - a + 1) for a, b in windows)


@pytest.mark.parametrize("M", [8, 512])
def test_plan_limits_raise(M):
    # a rank over 320 (the L tile path's ring) or K over 66311 (its i32
    # sums) takes the cooperative kernel at every M; up to them the tile
    # path; a forced tile path raises past them
    rows = 8 if M <= 8 else 32
    for rank, K_, bits, n in ((321, 4096, 4, 4096), (512, 4096, 4, 4096),
                              (16, 66320, 8, 256), (16, 66432, 4, 256)):
        assert K._w4a8_lr_plan(M, n, K_, bits, rank, (n,)) == dict(
            path="coop", rows=rows)
    assert K._w4a8_lr_plan(M, 4096, 4096, 4, 320, (4096,))["path"] == "tile"
    assert K._w4a8_lr_plan(M, 256, 66304, 8, 16, (256,))["path"] == "tile"
    with pytest.raises(ValueError, match="ranks"):
        K._w4a8_lr_plan(M, 4096, 4096, 4, 321, (4096,), path="tile")
    with pytest.raises(ValueError, match="i32"):
        K._w4a8_lr_plan(M, 256, 66320, 8, 16, (256,), path="tile")


def test_cpu_tensors_run_the_plain_version():
    # the plan is the card's: CPU tensors at prefill M run the plain version
    g = _group(5100, 40, (64,), 512, 16, 4)
    args = (g["x"], g["packed"], g["scales"], 0, g["R"], g["Rs"], g["L"],
            g["Ls"], 4, 16, (64,))
    before = K.quantized_matmul_w4a8_lr_stacked.launches
    y = K.quantized_matmul_w4a8_lr_stacked(*args)
    assert K.quantized_matmul_w4a8_lr_stacked.launches == before
    assert torch.equal(y, K.quantized_matmul_w4a8_lr_stacked_plain(*args))
