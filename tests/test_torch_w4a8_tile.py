"""The W4A8 kernel's tile path on the CPU: the plan that picks it
(``ops/kernels.py::_w4a8_plan``) and a plain model of its walk.

``csrc/w4a8_stacked.cu`` runs M above a threshold on int8 ``wgmma``: each
CTA walks its 128 weight rows in steps of 128 packed bytes; a step's raw
box, zero-filled past the end of a plane (or of N), unpacks into F tiles of
u8 codes, one a plane, and each multiplies its own activation box, at column
``p P + j0`` of x, zero-filled the same way (TMA's fill). Sixteen rows of
ones below every code tile make one column of the i32 sums the row sum of
xq, and the epilogue is ``((float)(acc - maxq rowsum) * s[n]) * sx[m]``.
The model below does exactly that with numpy integers and must equal the
plain version bit for bit; the card tests hold the kernel to both.
"""

import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K


def _tile_walk(xq, sx, packed, scales, bits, plan):
    """The tile kernel's arithmetic on the CPU: xq (M, K) int8, sx (M, 1),
    packed (N, P) uint8, scales (N, 1) f32, as numpy arrays."""
    M, Kd = xq.shape
    N, P = packed.shape
    f = 8 // bits
    maxq = 2 ** (bits - 1) - 1
    mask = (1 << bits) - 1
    bk, rows, cols = K._W4A8_TILE_BK, plan["rows"], plan["cols"]
    x_planes = xq.reshape(M, f, P)
    out = np.empty((M, N), np.float32)
    for m0 in range(0, M, rows):
        for n0 in range(0, N, cols):
            acc = np.zeros((rows, cols + 16), np.int64)
            for i in range(plan["steps"]):
                j0 = i * bk
                # TMA boxes: zero past the end of a plane, of N and of M
                raw = np.zeros((cols, bk), np.uint8)
                w = packed[n0:n0 + cols, j0:j0 + bk]
                raw[:w.shape[0], :w.shape[1]] = w
                for p in range(f):
                    codes = (raw >> (bits * (f - 1 - p))) & mask
                    b = np.vstack([codes, np.ones((16, bk), np.uint8)])
                    xb = np.zeros((rows, bk), np.int8)
                    xv = x_planes[m0:m0 + rows, p, j0:j0 + bk]
                    xb[:xv.shape[0], :xv.shape[1]] = xv
                    acc += xb.astype(np.int64) @ b.astype(np.int64).T
            # every partial sum is an i32 on the card
            assert np.abs(acc).max() < 2 ** 31
            rowsum = acc[:, cols]
            v = acc[:, :cols] - maxq * rowsum[:, None]
            mv, nv = min(rows, M - m0), min(cols, N - n0)
            y = ((v[:mv, :nv].astype(np.float32)
                  * scales[n0:n0 + nv, 0][None, :])
                 * sx[m0:m0 + mv, 0][:, None])
            out[m0:m0 + mv, n0:n0 + nv] = y
    return out


def _inputs(seed, M, N, Kd, bits, high, layers=2):
    rng = np.random.default_rng(seed)
    f = 8 // bits
    x = torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32))
    packed = torch.from_numpy(
        rng.integers(0, high, size=(layers, N, Kd // f), dtype=np.uint8))
    scales = torch.from_numpy(
        rng.uniform(0.001, 0.02, size=(layers, N, 1)).astype(np.float32))
    return x, packed, scales


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("Kd", [4096, 11008])
def test_tile_walk_equals_plain(bits, Kd):
    # 8-bit codes in [0, 254] (the grid's), two M tiles of 64 rows (the
    # second ragged) and two weight tiles (the second ragged); at 2 bits K
    # 11008 has planes of 2752 bytes, so the last step straddles each
    # plane's end
    M, N = 70, 136
    high = 255 if bits == 8 else 256
    x, packed, scales = _inputs(2000 + bits + Kd, M, N, Kd, bits, high)
    plan = K._w4a8_plan(M, N, Kd, bits, rows=64)
    assert plan["path"] == "tile" and plan["tiles"] == (2, 2)
    assert plan["grid"] == (4,)  # one persistent CTA a tile
    assert plan["straddle"] == (bits == 2 and Kd == 11008)
    ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 1, bits)
    xq, sx = K.quantize_activations_int8(x)
    got = _tile_walk(xq.numpy(), sx.numpy(), packed[1].numpy(),
                     scales[1].numpy(), bits, plan)
    assert np.array_equal(got, ref.numpy())


@pytest.mark.parametrize("rows", [64, 128])
def test_tile_walk_8bit_code_255(rows):
    # u8 codes keep the exact u - 127 = 128 (no int8 wrap at 255), as the
    # plain version's integer sum does
    M, N, Kd = 40, 130, 1024
    x, packed, scales = _inputs(2100 + rows, M, N, Kd, 8, 256)
    packed[1, :, :7] = 255
    plan = K._w4a8_plan(M, N, Kd, 8, rows=rows)
    ref = K.quantized_matmul_w4a8_stacked_plain(x, packed, scales, 1, 8)
    xq, sx = K.quantize_activations_int8(x)
    got = _tile_walk(xq.numpy(), sx.numpy(), packed[1].numpy(),
                     scales[1].numpy(), 8, plan)
    assert np.array_equal(got, ref.numpy())


@pytest.mark.parametrize("M,path,rows,cols", [
    (1, "rowdot", 8, 32), (8, "rowdot", 8, 32), (9, "tile", 64, 128),
    (16, "tile", 64, 128), (17, "tile", 64, 128), (64, "tile", 64, 128),
    (65, "tile", 128, 128), (2048, "tile", 128, 128)])
def test_plan_threshold_and_tiles(M, path, rows, cols):
    # decode (M <= 8) keeps the rowdot kernel; above, the tile kernel
    plan = K._w4a8_plan(M, 12288, 4096, 4)
    assert (plan["path"], plan["rows"], plan["cols"]) == (path, rows, cols)
    if path == "tile":
        tiles = (-(-M // rows), 96)
        assert plan["tiles"] == tiles
        # persistent CTAs, at most one an SM
        assert plan["grid"] == (min(tiles[0] * 96, 132),)
        assert plan["steps"] == 16 and not plan["straddle"]
    else:
        assert plan["grid"] == (12288 // cols, -(-M // rows))


@pytest.mark.parametrize("M,N,sms,rows", [
    # 64-row tiles while they are no more than the larger of the SM count
    # and the 128-row tiles
    (64, 22016, 132, 64), (96, 12288, 132, 128), (96, 12288, 264, 64),
    (128, 4096, 132, 64), (256, 4096, 132, 64), (512, 4096, 132, 128),
    (256, 4096, 100, 128), (192, 22016, 132, 128), (1000, 200, 132, 64)])
def test_plan_tile_rows_follow_the_grid(M, N, sms, rows):
    plan = K._w4a8_plan(M, N, 4096, 4, sms)
    assert plan["rows"] == rows
    assert plan["tiles"] == (-(-M // rows), -(-N // 128))


@pytest.mark.parametrize("N,Kd,bits,steps,straddle", [
    (4096, 4096, 4, 16, False), (4096, 11008, 4, 43, False),
    (4096, 11008, 2, 22, True), (4104, 1024, 8, 8, False),
    (200, 2048, 2, 4, False), (200, 1088, 4, 5, True)])
def test_plan_steps_and_plane_straddle(N, Kd, bits, steps, straddle):
    plan = K._w4a8_plan(512, N, Kd, bits)
    assert (plan["steps"], plan["straddle"]) == (steps, straddle)
    assert plan["tiles"] == (512 // plan["rows"], -(-N // 128))


def test_plan_overrides_and_k_overflow():
    # the tile kernel's i32 sums: 127 x 255 per product, so K <= 66311
    assert K._W4A8_TILE_MAX_K == 66311
    assert K._w4a8_plan(512, 256, 66311, 8)["path"] == "tile"
    with pytest.raises(ValueError, match="i32"):
        K._w4a8_plan(512, 256, 66320, 8)
    with pytest.raises(ValueError, match="i32"):
        K._w4a8_plan(8, 256, 66320, 8, path="tile")
    # the rowdot path keeps serving decode at any K
    assert K._w4a8_plan(8, 256, 66320, 8)["path"] == "rowdot"
    assert K._w4a8_plan(512, 4096, 4096, 4, path="rowdot")["rows"] == 32
    assert K._w4a8_plan(16, 4096, 4096, 4, path="rowdot")["grid"] == (512, 1)
    assert K._w4a8_plan(8, 4096, 4096, 4, path="tile")["rows"] == 64
    assert K._w4a8_plan(17, 4096, 4096, 4, rows=128)["tiles"] == (1, 32)
    assert K._w4a8_plan(512, 4096, 4096, 4, rows=64)["tiles"] == (8, 32)
    assert K._w4a8_plan(512, 4096, 4096, 4, rows=64)["grid"] == (132,)
    assert K._w4a8_plan(2048, 12288, 4096, 4, sms=100)["grid"] == (100,)
    with pytest.raises(ValueError, match="64 or 128"):
        K._w4a8_plan(512, 4096, 4096, 4, rows=32)
    with pytest.raises(ValueError, match="unknown"):
        K._w4a8_plan(512, 4096, 4096, 4, path="dp4a")


def test_cpu_tensors_run_the_plain_version():
    # the plan is the card's: CPU tensors at prefill M run the plain version
    x, packed, scales = _inputs(2200, 40, 64, 512, 4, 256)
    before = K.quantized_matmul_w4a8_stacked.launches
    y = K.quantized_matmul_w4a8_stacked(x, packed, scales, 0, 4)
    assert K.quantized_matmul_w4a8_stacked.launches == before
    assert torch.equal(y, K.quantized_matmul_w4a8_stacked_plain(
        x, packed, scales, 0, 4))
