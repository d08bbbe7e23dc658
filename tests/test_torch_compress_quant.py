"""PyTorch port, the quantizers of the compression pipeline: ``ops/
packing.py``, ``ops/blockquant.py``, ``quant/quantizers.py`` and ``ops/
lattice.py``, against the JAX reference on the CPU.

The same numpy inputs go through both. Codes, bytes and scales built from
exact operations (absmax, division, rounding, packing, the lattice's
Conway-Sloane round and hash lookups) must be equal bit for bit. Statistics
that are f32 sums (a block's mean and standard deviation, the E8P block
RMS) are summed in another order by XLA and by torch, so they agree to a few
f32 ulps; a code computed from them may then differ only where its input
sits on a rounding edge, which each test shows."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.ops import blockquant as JB
from ee274_convexcaldera_llm_quantization_tpu.ops import lattice as JLat
from ee274_convexcaldera_llm_quantization_tpu.ops import packing as JP
from ee274_convexcaldera_llm_quantization_tpu.quant import quantizers as JQ
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
    blockquant as TB)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import lattice as TLat
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import packing as TP
from ee274_convexcaldera_llm_quantization_tpu_torch.quant import (
    quantizers as TQ)

from test_torch_fused import _one_torch_thread  # noqa: F401 (a fixture)

# f32 sums of up to 256 terms in another order: a few ulps of the result
# (relative; each sum here is of values of one sign or near its magnitude)
STAT_RTOL = 8 * np.finfo(np.float32).eps


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _weights(seed, shape, outliers=True):
    """Gaussian weights with 1% of entries scaled by 20 (outliers for the
    bbint methods and heavy tails for the scales)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal(shape).astype(np.float32)
    if outliers:
        W[rng.random(shape) < 0.01] *= 20
    return W


# ---------------------------------------------------------------------------
# ops/packing.py
# ---------------------------------------------------------------------------

class TestPacking:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    def test_pack_codes_bytes_equal(self, bits):
        rng = np.random.default_rng(bits)
        codes = rng.integers(0, 2 ** bits, size=(3, 5, 64)).astype(np.uint8)
        ref = np.asarray(JP.pack_codes(jnp.asarray(codes), bits))
        got = TP.pack_codes(torch.from_numpy(codes), bits)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)        # bit-exact
        np.testing.assert_array_equal(TP.unpack_codes(got, bits).numpy(),
                                      codes)

    @pytest.mark.parametrize("bits", [2, 3, 4])
    def test_pack_signed_bytes_equal(self, bits):
        rng = np.random.default_rng(10 + bits)
        maxq = 2 ** (bits - 1) - 1
        codes = rng.integers(-maxq, maxq + 1, size=(7, 32)).astype(np.int8)
        pack_bits = 4 if bits == 3 else bits
        if bits == 3:
            # the reference packs a 3-bit grid only in the 4-bit container
            # (offset 7, not 3); pack_signed needs a native width
            with pytest.raises(ValueError):
                TP.pack_signed(torch.from_numpy(codes), 3)
        ref = np.asarray(JP.pack_signed(jnp.asarray(codes), pack_bits))
        got = TP.pack_signed(torch.from_numpy(codes), pack_bits)
        np.testing.assert_array_equal(got.numpy(), ref)        # bit-exact
        back = TP.unpack_signed(got, pack_bits)
        assert back.dtype == torch.int32
        np.testing.assert_array_equal(back.numpy(), codes)

    def test_bad_widths_raise(self):
        c = torch.zeros((2, 5), dtype=torch.uint8)
        with pytest.raises(ValueError, match="divisible"):
            TP.pack_codes(c, 4)
        with pytest.raises(ValueError, match="cannot pack"):
            TP.pack_codes(c, 3)
        with pytest.raises(ValueError, match="cannot unpack"):
            TP.unpack_codes(c, 5)

    def test_coo_round_trip_equal(self):
        rng = np.random.default_rng(3)
        mask = rng.random((6, 16)) < 0.1
        vals = rng.standard_normal((6, 16)).astype(np.float32)
        for a, b in zip(TP.mask_to_coo(mask, vals),
                        JP.mask_to_coo(mask, vals)):
            np.testing.assert_array_equal(a, b)
        idx, v = TP.mask_to_coo(mask, vals)
        for a, b in zip(TP.coo_to_mask(mask.shape, idx, v),
                        JP.coo_to_mask(mask.shape, idx, v)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# ops/blockquant.py and quant/quantizers.py
# ---------------------------------------------------------------------------

_ABSMAX = [("uniform", 2), ("uniform", 3), ("uniform", 4), ("uniform", 8),
           ("uniform", 16), ("nf4", 4), ("nf4_true", 4), ("nf2", 2)]
_STATS = [("nf4_meanstd", 4), ("bbint4", 4), ("bbint2", 2)]


def _both_quantize(method, bits, block_size, W):
    jq = JQ.BlockQuantizer(bits, method, block_size).quantize(jnp.asarray(W))
    tq = TQ.BlockQuantizer(bits, method, block_size).quantize(
        torch.from_numpy(W))
    return jq, tq


class TestBlockQuantizers:
    @pytest.mark.parametrize("method,bits", _ABSMAX)
    @pytest.mark.parametrize("block_size", [64, "global"])
    def test_absmax_methods_bit_exact(self, method, bits, block_size):
        W = _weights(20 + bits, (32, 128))
        jq, tq = _both_quantize(method, bits, block_size, W)
        # absmax, one division and round-half-even: exact on both sides
        np.testing.assert_array_equal(_np(tq.codes), np.asarray(jq.codes))
        assert _np(tq.codes).dtype == np.asarray(jq.codes).dtype
        np.testing.assert_array_equal(_np(tq.scale), np.asarray(jq.scale))
        np.testing.assert_array_equal(_np(tq.packed_codes()),
                                      np.asarray(jq.packed_codes()))
        assert tq.storage_bits() == jq.storage_bits()
        tdq = TQ.BlockQuantizer(bits, method, block_size)
        jdq = JQ.BlockQuantizer(bits, method, block_size)
        np.testing.assert_array_equal(
            tdq.dequantize(tq).numpy(), np.asarray(jdq.dequantize(jq)))
        # the reference's round trip is jitted, and XLA reassociates the
        # uniform dequantization codes / maxq * absmax into codes * (absmax
        # * (1 / maxq)): one f32 rounding apart (its eager dequantize above
        # is the expression as written, equal bit for bit)
        np.testing.assert_allclose(
            tdq.quantize_dequantize(torch.from_numpy(W)).numpy(),
            np.asarray(jdq.quantize_dequantize(jnp.asarray(W))),
            rtol=2 * np.finfo(np.float32).eps, atol=0)

    @pytest.mark.parametrize("method,bits", _STATS)
    def test_statistics_methods(self, method, bits):
        W = _weights(30 + bits, (32, 256))
        jq, tq = _both_quantize(method, bits, 64, W)
        blocks = W.reshape(-1, 64)
        levels = np.asarray(JB.nf_levels(method)) if method.startswith(
            "nf") else None
        # mean (zero) and std (scale): f32 sums in another order
        if method == "nf4_meanstd":
            for a, b in ((tq.zero, jq.zero), (tq.scale, jq.scale)):
                np.testing.assert_allclose(_np(a), np.asarray(b),
                                           rtol=STAT_RTOL, atol=1e-7)
            # a differing code must sit on an edge: its standardized input
            # within a few ulps of a midpoint between two levels
            diff = _np(tq.codes) != np.asarray(jq.codes)
            if diff.any():
                mids = (levels[:-1] + levels[1:]) / 2
                z = (blocks - np.asarray(jq.zero)) / np.asarray(jq.scale)
                gap = np.abs(z[diff][:, None] - mids[None]).min(axis=1)
                assert gap.max() <= 16 * np.finfo(np.float32).eps
        else:
            # bbint: the mask compares |x - mean| with 6 std; a flip must sit
            # within a few ulps of that edge, and blocks whose masks agree
            # have equal min, scale and codes (min and max are exact)
            mask_t, mask_j = _np(tq.outlier_mask), np.asarray(jq.outlier_mask)
            flips = mask_t != mask_j
            if flips.any():
                mean = blocks.mean(axis=1, keepdims=True)
                std = blocks.std(axis=1, ddof=1, keepdims=True)
                edge = np.abs(np.abs(blocks - mean) - 6 * std)
                assert (edge[flips] <= 1e-5 * (6 * std).repeat(
                    64, axis=1)[flips]).all()
            same = ~flips.any(axis=1)
            assert same.mean() > 0.9
            for a, b in ((tq.codes, jq.codes), (tq.zero, jq.zero),
                         (tq.scale, jq.scale),
                         (tq.outlier_values, jq.outlier_values)):
                np.testing.assert_array_equal(_np(a)[same],
                                              np.asarray(b)[same])
            np.testing.assert_array_equal(mask_t[same], mask_j[same])
            assert tq.num_outliers() == jq.num_outliers()
            assert tq.storage_bits() == jq.storage_bits()
            np.testing.assert_array_equal(_np(tq.packed_codes())[same],
                                          np.asarray(jq.packed_codes())[same])
        # the round trip restores outliers exactly and stays on the grid
        dq = TQ.BlockQuantizer(bits, method, 64).dequantize(tq).numpy()
        ref = np.asarray(JQ.BlockQuantizer(bits, method, 64).dequantize(jq))
        np.testing.assert_allclose(dq, ref, rtol=1e-5, atol=1e-5)

    def test_ddof_conventions(self):
        # nf4_meanstd standardizes by the population std (jnp.std's ddof
        # 0), the outlier test by the Bessel-corrected one (ddof 1)
        blocks = torch.from_numpy(_weights(5, (4, 64), outliers=False))
        levels = TB.nf_levels("nf4_meanstd")
        _, _, std = TB.nf_meanstd_quantize_blocks(blocks, levels)
        np.testing.assert_allclose(
            std.numpy()[:, 0], blocks.numpy().std(axis=1), rtol=1e-6)
        x = np.zeros((1, 64), np.float32)
        x[0, :32], x[0, 32:] = -1.0, 1.0
        x[0, 0] = 7.0
        q = TB.affine_outlier_quantize_blocks(torch.from_numpy(x), 4)
        jq = JB.affine_outlier_quantize_blocks(jnp.asarray(x), 4)
        np.testing.assert_array_equal(q.outlier_mask.numpy(),
                                      np.asarray(jq.outlier_mask))

    def test_errors_and_factory(self):
        W = torch.zeros((3, 10))
        with pytest.raises(ValueError, match="not divisible"):
            TQ.BlockQuantizer(4, "uniform", 64).quantize(W)
        with pytest.raises(ValueError, match="2-D"):
            TQ.BlockQuantizer(4, "uniform", 64).quantize(torch.zeros(8))
        with pytest.raises(ValueError):
            TQ.BlockQuantizer(2, "nf4")
        with pytest.raises(ValueError):
            TQ.BlockQuantizer(4, "e8p")
        with pytest.raises(ValueError, match="bit-width"):
            TQ.BlockQuantizer(5)
        with pytest.raises(NotImplementedError):
            TQ.BlockQuantizer(4, "kmeans")
        f = TQ.QuantizerFactory(method="nf4", block_size=32)
        assert hash(f) == hash(TQ.QuantizerFactory("nf4", 32))
        with pytest.raises(dataclasses.FrozenInstanceError):
            f.method = "uniform"
        q = f.get_quantizer(4)
        assert (q.num_bits, q.method, q.block_size) == (4, "nf4", 32)
        assert str(f) == str(JQ.QuantizerFactory("nf4", 32))
        assert repr(q) == repr(JQ.QuantizerFactory("nf4", 32)
                               .get_quantizer(4))


# ---------------------------------------------------------------------------
# ops/lattice.py
# ---------------------------------------------------------------------------

def _dist2(y, cb, idx):
    return ((y - cb[np.asarray(idx, np.int64)]) ** 2).sum(axis=1)


class TestLattice:
    def test_tables_equal(self):
        # numpy on both sides: equal as arrays
        np.testing.assert_array_equal(TLat.e8p_codebook(),
                                      JLat.e8p_codebook())
        jm, jk, jo = JLat._hash_table()
        tm, tk, to = TLat.hash_table()
        assert tm == jm
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(TLat.e8_roots(), JLat.e8_roots())
        assert TLat._shell_radii2() == JLat._shell_radii2()
        assert TLat.codebook_radius2() == JLat.codebook_radius2()

    def test_nearest_e8_equal(self):
        y = (0.8 * np.random.default_rng(1).standard_normal(
            (512, 8))).astype(np.float32)
        np.testing.assert_array_equal(
            TLat.nearest_e8(torch.from_numpy(y)).numpy(),
            np.asarray(JLat.nearest_e8(jnp.asarray(y))))

    @pytest.mark.parametrize("scale", [0.6, 1.2, 2.4])
    @pytest.mark.parametrize("exact", [False, True])
    def test_encode_indices(self, scale, exact):
        # scale 2.4 puts most rows outside the codebook ball (the descent /
        # brute-force fallback)
        y = (scale * np.random.default_rng(2).standard_normal(
            (1024, 8))).astype(np.float32)
        cb = JLat.e8p_codebook()
        ref = np.asarray(JLat.e8p_encode(jnp.asarray(y), jnp.asarray(cb),
                                         exact=exact))
        got = TLat.e8p_encode(torch.from_numpy(y), TLat.codebook_on("cpu"),
                              exact=exact)
        assert got.dtype == torch.int32
        got = got.numpy()
        diff = got != ref
        # where an index differs the two codewords are a near tie: their
        # distances to y agree within f32 rounding of ||y - c||^2
        d_t, d_j = _dist2(y, cb, got), _dist2(y, cb, ref)
        np.testing.assert_allclose(d_t[diff], d_j[diff], rtol=1e-5,
                                   atol=1e-5)
        assert diff.mean() <= 0.01

    def test_encode_slab_is_row_independent(self):
        y = (2.0 * np.random.default_rng(4).standard_normal(
            (600, 8))).astype(np.float32)
        cb = TLat.codebook_on("cpu")
        whole = TLat.e8p_encode(torch.from_numpy(y), cb)
        slabbed = TLat.e8p_encode(torch.from_numpy(y), cb, slab=128)
        assert torch.equal(whole, slabbed)

    def test_quantize_blocks(self):
        W = _weights(6, (48, 64), outliers=False)
        jc, js = JLat.e8p_quantize_blocks(jnp.asarray(W))
        tc, ts = TLat.e8p_quantize_blocks(torch.from_numpy(W))
        jc, js = np.asarray(jc).astype(np.int64), np.asarray(js)
        # the block RMS is an f32 mean summed in another order (ulps), so the
        # chosen scale agrees to those ulps; the codes are then equal except
        # where a rescaled input sits on a lattice tie
        np.testing.assert_allclose(ts.numpy(), js, rtol=STAT_RTOL)
        same = tc.numpy() == jc
        assert same.mean() >= 0.99
        cb = JLat.e8p_codebook()
        y = (W / js).reshape(-1, 8)
        diff = ~same.reshape(-1)
        np.testing.assert_allclose(_dist2(y, cb, tc.numpy().reshape(-1))[diff],
                                   _dist2(y, cb, jc.reshape(-1))[diff],
                                   rtol=1e-4, atol=1e-4)
        # the TB.quantize_dequantize e8p route is the same computation
        np.testing.assert_array_equal(
            TB.quantize_dequantize(torch.from_numpy(W), 2, "e8p",
                                   64).numpy(),
            TLat.e8p_dequantize_blocks(tc, ts).numpy().reshape(W.shape))

    def test_recover_codes_exact(self):
        W = _weights(7, (16, 64), outliers=False)
        codes, s = TLat.e8p_quantize_blocks(torch.from_numpy(W))
        Q = TLat.e8p_dequantize_blocks(codes, s)
        rc, rs = TLat.e8p_recover_codes(Q)
        # grid values: one candidate scale is the block's own up to the
        # rounding of 4 max|v| / (2M + 1), so the codes come back exactly
        # and the values to an ulp
        np.testing.assert_array_equal(rc.numpy(), codes.numpy())
        np.testing.assert_allclose(rs.numpy(), s.numpy(),
                                   rtol=2 * np.finfo(np.float32).eps)
        np.testing.assert_allclose(
            TLat.e8p_dequantize_blocks(rc, rs).numpy(), Q.numpy(),
            rtol=2 * np.finfo(np.float32).eps, atol=0)
        jc, jsc = JLat.e8p_recover_codes(jnp.asarray(Q.numpy()))
        np.testing.assert_array_equal(rc.numpy(), np.asarray(jc))
        # XLA compiles 4 * g / (2M + 1) as g * (4 / (2M + 1)): an ulp apart
        np.testing.assert_allclose(rs.numpy(), np.asarray(jsc),
                                   rtol=2 * np.finfo(np.float32).eps)

    def test_pack_rowscale(self):
        W = _weights(8, (64, 128), outliers=False)
        jp, jh, jo = (np.asarray(a) for a in
                      JLat.e8p_pack_rowscale(jnp.asarray(W)))
        tp, th, to = (a.numpy() for a in
                      TLat.e8p_pack_rowscale(torch.from_numpy(W)))
        # codes to bytes is exact; a row whose RMS agrees bit for bit gives
        # equal scales, the others differ by the RMS's ulps
        np.testing.assert_array_equal(tp, jp)                  # bit-exact
        np.testing.assert_allclose(th, jh, rtol=STAT_RTOL)
        np.testing.assert_allclose(to, jo, rtol=STAT_RTOL)
        np.testing.assert_array_equal(th / 2, to)
        # the int4 pack round-trips losslessly through the 2-bit codes
        codes = TLat.int4_planes_to_codes(torch.from_numpy(tp))
        np.testing.assert_array_equal(
            codes.numpy(), np.asarray(JLat.int4_planes_to_codes(
                jnp.asarray(jp))))
        np.testing.assert_array_equal(
            TLat.codes_to_int4_planes(codes, 128).numpy(), tp)
        with pytest.raises(ValueError, match="lattice-codeword"):
            TLat.int4_planes_to_codes(torch.full((2, 8), 0xFF,
                                                 dtype=torch.uint8))

    def test_block_size_must_be_multiple_of_8(self):
        with pytest.raises(ValueError, match="multiple of 8"):
            TLat.e8p_quantize_blocks(torch.zeros((2, 12)))
