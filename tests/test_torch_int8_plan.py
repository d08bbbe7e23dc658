"""The int8 head kernel's tile path on the CPU: the plan that picks it
(``ops/kernels.py::_int8_plan``), a plain model of its walk, and the launch
routes of the int8 and W4A8 wrappers (the persistent W4A8 launch above
decode M) with a stand-in for the compiled library.

``csrc/int8_matmul.cu`` runs every M on int8 ``wgmma``: a tile is 128 A
rows by ``NB`` B rows, the weights as A and the activations as B (64 of
them) when swapped (M <= 64), the other way round above; each 128-byte k step
brings one TMA box of each, zero-filled past K, M and N (TMA's fill), and
the epilogue is ``((float)acc * s[n]) * sx[m]`` on every output inside (M,
N). The model below does exactly that with numpy integers and must equal
the plain version bit for bit; the card tests hold the kernel to both.
"""

import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

_BK = 128  # k bytes a step


def _tile_walk(xq, sx, w8, s, plan, sms=7):
    """The tile kernel's arithmetic and walk on the CPU: xq (M, K) int8, sx
    (M, 1), w8 (N, K) int8, s (N, 1) f32 as numpy arrays; ``sms`` CTAs walk
    tiles b, b + sms, ... (A tiles fastest). Every output is written once."""
    M, Kd = xq.shape
    N = w8.shape[0]
    swap = plan["swap"]
    a, b = (w8, xq) if swap else (xq, w8)
    a_rows, b_rows = 128, plan["rows"] if swap else plan["cols"]
    a_tiles, b_tiles = plan["tiles"]
    assert a_tiles == -(-a.shape[0] // a_rows)
    assert b_tiles == -(-b.shape[0] // b_rows)
    out = np.full((M, N), np.nan, np.float32)
    written = np.zeros((M, N), np.int64)
    for cta in range(sms):
        for tile in range(cta, a_tiles * b_tiles, sms):
            a0, b0 = tile % a_tiles * a_rows, tile // a_tiles * b_rows
            acc = np.zeros((a_rows, b_rows), np.int64)
            for k0 in range(0, Kd, _BK):
                # TMA boxes: zero past K and past the last row
                ab = np.zeros((a_rows, _BK), np.int64)
                av = a[a0:a0 + a_rows, k0:k0 + _BK]
                ab[:av.shape[0], :av.shape[1]] = av
                bb = np.zeros((b_rows, _BK), np.int64)
                bv = b[b0:b0 + b_rows, k0:k0 + _BK]
                bb[:bv.shape[0], :bv.shape[1]] = bv
                acc += ab @ bb.T
                # every partial sum is an i32 on the card
                assert np.abs(acc).max() < 2 ** 31
            d = acc.T if swap else acc  # (activation rows, weight rows)
            m0, n0 = (b0, a0) if swap else (a0, b0)
            mv, nv = min(d.shape[0], M - m0), min(d.shape[1], N - n0)
            y = ((d[:mv, :nv].astype(np.float32)
                  * s[n0:n0 + nv, 0][None, :])
                 * sx[m0:m0 + mv, 0][:, None])
            out[m0:m0 + mv, n0:n0 + nv] = y
            written[m0:m0 + mv, n0:n0 + nv] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("M,N,Kd,rows,cols", [
    # swapped: M within one B box, a ragged last weight tile, K not a
    # multiple of the 128-byte step (the last box zero-filled)
    (9, 300, 256, 64, 128), (17, 200, 272, 64, 128), (40, 130, 256, 64, 128),
    # swapped in several M tiles (any N, here N % 4 != 0)
    (100, 301, 256, 64, 128), (170, 257, 144, 64, 128),
    # not swapped: ragged M and N, 128- and 256-row weight tiles
    (65, 300, 256, 128, 128), (130, 1000, 256, 128, 256),
    (260, 132, 400, 128, 128)])
def test_tile_walk_equals_plain(M, N, Kd, rows, cols):
    rng = np.random.default_rng(M + N + Kd)
    x = torch.from_numpy(rng.normal(size=(M, Kd)).astype(np.float32))
    w8 = torch.from_numpy(rng.integers(-127, 128, size=(N, Kd),
                                       dtype=np.int8))
    s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(N, 1))
                         .astype(np.float32))
    plan = K._int8_plan(M, N, Kd, 7, rows=rows, cols=cols)
    assert plan["grid"] == (min(7, plan["tiles"][0] * plan["tiles"][1]),)
    xq, sx = K.quantize_activations_int8(x)
    y = _tile_walk(xq.numpy(), sx.numpy(), w8.numpy(), s.numpy(), plan)
    np.testing.assert_array_equal(y, K.int8_matmul_plain(x, w8, s).numpy())


def _expected(M, N, sms=132):
    """The plan's rule, written out: (swap, rows, cols)."""
    if M <= 64 or N % 4:
        return True, 64, 128
    wide = -(-M // 128) * -(-N // 256) >= 2 * sms
    return False, 128, 256 if wide else 128


@pytest.mark.parametrize("M", [1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 48,
                               63, 64, 65, 100, 127, 128, 129, 300, 512,
                               1000, 1024, 2048, 4096])
@pytest.mark.parametrize("N", [32000, 1001])
def test_plan_route_and_tiles(M, N):
    plan = K._int8_plan(M, N, 4096)
    swap, rows, cols = _expected(M, N)
    assert (plan["rows"], plan["cols"]) == (rows, cols)
    assert plan["swap"] is swap
    tiles = ((-(-N // 128), -(-M // rows)) if swap
             else (-(-M // 128), -(-N // cols)))
    assert plan["tiles"] == tiles
    assert plan["grid"] == (min(132, tiles[0] * tiles[1]),)


def test_plan_k_overflow_and_overrides():
    # 127 x 127 per product: the i32 sums hold K <= 133144
    assert K._INT8_TILE_MAX_K == 133144
    assert K._int8_plan(512, 256, 133144)["tiles"] == (4, 2)
    assert K._int8_plan(8, 256, 133144)["tiles"] == (2, 1)
    with pytest.raises(ValueError, match="i32"):
        K._int8_plan(512, 256, 133152)
    with pytest.raises(ValueError, match="i32"):
        K._int8_plan(8, 256, 133152)
    assert K._int8_plan(1024, 4096, 4096, rows=64)["tiles"] == (32, 16)
    assert K._int8_plan(8, 4096, 4096, rows=128)["tiles"] == (1, 32)
    assert K._int8_plan(1024, 4096, 4096, cols=256)["tiles"] == (8, 16)
    assert K._int8_plan(1024, 4096, 4096, cols=128)["tiles"] == (8, 32)
    # 256-row weight tiles while they make two tiles an SM
    assert K._int8_plan(512, 32000, 4096)["cols"] == 256
    assert K._int8_plan(256, 32000, 4096)["cols"] == 128
    assert K._int8_plan(512, 32000, 4096, sms=300)["cols"] == 128
    assert K._int8_plan(2048, 32000, 4096, sms=100)["grid"] == (100,)
    for rows in (8, 16, 32, 48, 256):
        with pytest.raises(ValueError, match="activation rows"):
            K._int8_plan(512, 4096, 4096, rows=rows)
    with pytest.raises(ValueError, match="weight rows"):
        K._int8_plan(32, 4096, 4096, cols=256)
    with pytest.raises(ValueError, match="weight rows"):
        K._int8_plan(512, 4096, 4096, cols=64)
    with pytest.raises(ValueError, match="N % 4"):
        K._int8_plan(512, 4097, 4096, rows=128)


class _Lib:
    """A stand-in for a compiled library: records each entry's call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(K._build, "library", lambda name: lib)
    monkeypatch.setattr(K._build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(K, "_sm_count", lambda index: 132)
    monkeypatch.setattr(K.torch.cuda, "current_device", lambda: 0)
    return lib


@pytest.mark.parametrize("rows", [None, 64])
@pytest.mark.parametrize("M", [1, 8, 9, 33, 64, 65, 1024])
@pytest.mark.parametrize("N", [300, 1001])
def test_int8_launch_takes_the_plan(fake_lib, M, N, rows):
    Kd = 256
    xq = torch.zeros((M, Kd), dtype=torch.int8)
    sx = torch.ones((M, 1))
    w8 = torch.zeros((N, Kd), dtype=torch.int8)
    s = torch.ones((N, 1))
    out = K._launch_int8_matmul(xq, sx, w8, s, rows=rows)
    assert out.shape == (M, N) and out.dtype == torch.float32
    plan = K._int8_plan(M, N, Kd, rows=rows)
    assert plan["swap"] is (rows == 64 or M <= 64 or N % 4 != 0)
    (name, args), = fake_lib.calls
    assert name == "int8_tile_launch"
    assert args[5:11] == (M, N, Kd, plan["rows"], plan["cols"],
                          plan["grid"][0])


@pytest.mark.parametrize("M", [1, 8, 9, 64, 512])
@pytest.mark.parametrize("persistent", [False, True])
def test_w4a8_persistent_launch_above_m8_takes_the_tile_path(
        fake_lib, M, persistent):
    # row 4: the persistent launch runs the weight stream on its plan at
    # decode M and the grid launch's tile plan above it (bit-equal outputs);
    # the stream's split counters ask the capture id first
    N, Kd, bits = 4096, 4096, 4
    xq = torch.zeros((M, Kd), dtype=torch.int8)
    sx = torch.ones((M, 1))
    packed = torch.zeros((2, N, Kd // 2), dtype=torch.uint8)
    scales = torch.ones((2, N, 1))
    K._launch_w4a8_stacked(xq, sx, packed, scales, 1, bits,
                           persistent=persistent)
    (name, args), = [c for c in fake_lib.calls
                     if c[0] != "grouped_capture_id"]
    plan = K._w4a8_plan(M, N, Kd, bits)
    if M <= K._W4A8_ROWDOT_MAX_M:
        assert plan["path"] == "rowdot"
        assert name == ("w4a8_stacked_persistent_launch" if persistent
                        else "w4a8_stacked_launch")
        if persistent:
            sp = K._w4a8_stream_plan(M, N, Kd, bits, 132)
            assert args[6:13] == (M, N, Kd, bits, 1, sp["ctas"],
                                  sp["warps"])
    else:
        assert name == "w4a8_tile_launch"
        assert args[5:12] == (M, N, Kd, bits, 1, plan["rows"],
                              plan["grid"][0])


def test_int8_plain_route_on_cpu_tensors():
    # the wrapper takes the plain version for CPU tensors, at every M
    rng = np.random.default_rng(3)
    for M in (8, 40, 130):
        x = torch.from_numpy(rng.normal(size=(M, 64)).astype(np.float32))
        w8 = torch.from_numpy(rng.integers(-127, 128, size=(50, 64),
                                           dtype=np.int8))
        s = torch.from_numpy(rng.uniform(0.001, 0.02, size=(50, 1))
                             .astype(np.float32))
        before = K.int8_matmul.launches
        assert torch.equal(K.int8_matmul(x, w8, s),
                           K.int8_matmul_plain(x, w8, s))
        assert K.int8_matmul.launches == before
