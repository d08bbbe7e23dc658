"""PyTorch port, the CALDERA solver: ``ops/kernels.py``'s FWHT and Hadamard
sandwich, ``decomp/lowrank.py`` and ``decomp/caldera.py``, against the JAX
reference on the CPU.

The same numpy inputs go through both solvers (``scale_W=False``: the
global scale is an f32 mean whose sum order differs). SVD and eigh factors
may differ in sign and inside near-degenerate subspaces, so the tests hold
products (``L @ R``, ``H^{1/2}``) and errors, never the factors. Exact
pieces are held bit for bit: LDLQ at H = I is per-row RTN, and LDLQ given
the same ``U`` rounds to the same codes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.decomp import caldera as JC
from ee274_convexcaldera_llm_quantization_tpu.decomp import lowrank as JLR
from ee274_convexcaldera_llm_quantization_tpu.ops import kernels as JK
from ee274_convexcaldera_llm_quantization_tpu.quant.quantizers import (
    QuantizerFactory as JQF)
from ee274_convexcaldera_llm_quantization_tpu_torch.decomp import (
    caldera as TC)
from ee274_convexcaldera_llm_quantization_tpu_torch.decomp import (
    lowrank as TLR)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import (
    blockquant as TB)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as TK
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import lattice as TLat
from ee274_convexcaldera_llm_quantization_tpu_torch.quant.quantizers import (
    QuantizerFactory as TQF)

from test_torch_fused import _one_torch_thread  # noqa: F401 (a fixture)

F32_EPS = np.finfo(np.float32).eps
# The two solvers on the same W and H: every step is the same f32 math with
# sums in another order, and the SVD / eigh of another LAPACK routine. Under
# RTN the alternation stays on the same codes and the errors agree to a few
# f32 ulps of the error (read: 6e-8 at 256 x 256); bound 1e-5 absolute.
ERR_ATOL = 1e-5
# LDLQ rounds every column after feedback through U, so an ulp of U or of
# the residual can round a code the other way and the sweeps part; the
# solvers' best errors then differ by what a few flipped codes move (read:
# 1.3e-3 relative on the well-conditioned H below). Bound: 2% relative, the
# reference's own bound between panel widths (tests/test_ldlq.py).
LDLQ_RTOL = 0.02


def _W(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _hessian(n, seed=0, mix=0.3):
    """A correlated, well-conditioned second moment (condition ~10): 8n
    samples of x = z (I + mix G / sqrt(n))."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((8 * n, n)).astype(np.float32)
    X = X @ (np.eye(n) + mix * rng.standard_normal((n, n)) / np.sqrt(n))
    return (X.T @ X / (8 * n)).astype(np.float32)


def _aa(W, Q, H):
    E = Q - W
    return float(np.sqrt(np.sum((E @ H) * E) / np.sum((W @ H) * W)))


def _params(**kw):
    base = dict(Q_bits=2, L_bits=16, R_bits=16, rank=8, iters=2,
                lplr_iters=2)
    base.update(kw)
    jkw = dict(base)
    tkw = dict(base)
    for key in ("quant_factory_Q", "quant_factory_LR"):
        if key in base:
            method, bs = base[key]
            jkw[key] = JQF(method=method, block_size=bs)
            tkw[key] = TQF(method=method, block_size=bs)
    return JC.CalderaParams(**jkw), TC.CalderaParams(**tkw)


def _solve(kw, W, H=None):
    jp, tp = _params(**kw)
    dj = JC.caldera(jp, jnp.asarray(W), None if H is None else jnp.asarray(H),
                    scale_W=False)
    dt = TC.caldera(tp, torch.from_numpy(W),
                    None if H is None else torch.from_numpy(H),
                    scale_W=False)
    return dj, dt


def _rel(W, W_hat):
    return float(np.linalg.norm(W_hat - W) / np.linalg.norm(W))


# ---------------------------------------------------------------------------
# FWHT and the Hadamard sandwich
# ---------------------------------------------------------------------------

class TestHadamard:
    @pytest.mark.parametrize("axis", [0, 1, -1])
    def test_fwht_equal(self, axis):
        x = _W(1, (64, 32))
        # the same butterflies in the same order: sums of the same pairs
        np.testing.assert_array_equal(
            TK.fwht(torch.from_numpy(x), axis=axis).numpy(),
            np.asarray(JK.fwht(jnp.asarray(x), axis=axis)))
        with pytest.raises(ValueError, match="power of two"):
            TK.fwht(torch.zeros((3, 6)))

    def test_sandwich(self):
        W = _W(2, (48, 80))
        tr, m2, n2 = TK.hadamard_sandwich(torch.from_numpy(W))
        jr, jm2, jn2 = JK.hadamard_sandwich(jnp.asarray(W))
        assert (m2, n2) == (jm2, jn2) == (64, 128)
        # the butterflies are equal; the final division by sqrt(m2 n2) is
        # the same f32 division
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        back = TK.hadamard_unsandwich(tr, 48, 80).numpy()
        np.testing.assert_array_equal(
            back, np.asarray(JK.hadamard_unsandwich(jr, 48, 80)))
        np.testing.assert_allclose(back, W, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# decomp/lowrank.py
# ---------------------------------------------------------------------------

class TestLowRank:
    def test_lstsq_qr(self):
        A, B = _W(3, (64, 8)), _W(4, (64, 5))
        ref = np.asarray(JLR.lstsq_qr(jnp.asarray(A), jnp.asarray(B)))
        got = TLR.lstsq_qr(torch.from_numpy(A), torch.from_numpy(B)).numpy()
        # a well-conditioned 64 x 8 solve: f32 rounding of both libraries
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    def test_eigh_sqrt_and_regression(self):
        n = 48
        H = _hessian(n, seed=5)
        H[0] *= 0  # singular: the shift to sigma_reg takes over
        H[:, 0] *= 0
        jH, jeig = JLR.regularized_eigh(jnp.asarray(H), 0.05)
        tH, teig = TLR.regularized_eigh(torch.from_numpy(H), 0.05)
        np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(teig.eigenvalues.numpy(),
                                   np.asarray(jeig.eigenvalues), rtol=1e-4,
                                   atol=1e-5)
        assert float(teig.eigenvalues.min()) == pytest.approx(0.05, rel=1e-4)
        # products, not factors: H^{1/2} and the regression's L @ R (f32
        # eigh/SVD of two libraries on a matrix of condition ~200)
        ts = TLR.hessian_sqrt(teig)
        np.testing.assert_allclose(ts.numpy(),
                                   np.asarray(JLR.hessian_sqrt(jeig)),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose((ts @ ts).numpy(), tH.numpy(), atol=1e-4)
        res = _W(6, (32, n))
        jL, jR = JLR.rank_constrained_regression(
            jnp.asarray(res), JLR.hessian_sqrt(jeig), jeig, 6)
        tL, tR = TLR.rank_constrained_regression(
            torch.from_numpy(res), ts, teig, 6)
        np.testing.assert_allclose((tL @ tR).numpy(),
                                   np.asarray(jL @ jR), rtol=1e-3, atol=1e-3)

    def test_randomized_svd_close_to_exact(self):
        # a decaying spectrum: the randomized range finder captures the
        # top-8 subspace, so its truncation error is within 1% of exact
        rng = np.random.default_rng(7)
        U, _ = np.linalg.qr(rng.standard_normal((96, 96)))
        V, _ = np.linalg.qr(rng.standard_normal((64, 64)))
        Y = ((U[:, :64] * 0.7 ** np.arange(64)) @ V.T).astype(np.float32)
        g = torch.Generator().manual_seed(0)
        Ur, Sr, Vr = TLR.randomized_svd(torch.from_numpy(Y), 8, g)
        Ue, Se, Ve = TLR.truncated_svd(torch.from_numpy(Y), 8)
        er = np.linalg.norm(Y - ((Ur * Sr) @ Vr).numpy())
        ee = np.linalg.norm(Y - ((Ue * Se) @ Ve).numpy())
        assert er <= 1.01 * ee + 1e-6


# ---------------------------------------------------------------------------
# decomp/caldera.py
# ---------------------------------------------------------------------------

class TestCaldera:
    def test_identity_hessian_reference_band(self):
        # the JAX suite's smoke case: Q 2-bit global, rank 32, iters 3 on a
        # seeded 256 x 256 matrix lands in the reference band 0.70-0.80
        W = _W(0, (256, 256))
        dj, dt = _solve(dict(rank=32, iters=3, lplr_iters=5), W)
        et = _rel(W, dt.reconstruct().numpy())
        ej = _rel(W, np.asarray(dj.reconstruct()))
        assert 0.70 <= et <= 0.80
        assert abs(et - ej) <= ERR_ATOL
        for key in ("Q", "LR"):
            np.testing.assert_allclose(dt.errors[key], dj.errors[key],
                                       rtol=0, atol=ERR_ATOL)
        assert dt.global_scale == 1.0

    @pytest.mark.parametrize("kw", [
        dict(),                                               # RTN
        dict(L_bits=4, R_bits=4, quant_factory_LR=("uniform", "global")),
        dict(quant_factory_Q=("nf2", 64), activation_aware_LR=False),
        dict(update_order=("LR", "Q")),
    ], ids=["rtn", "lplr-4bit", "nf2-unaware", "lr-first"])
    def test_correlated_hessian_matches(self, kw):
        W, H = _W(8, (64, 96)), _hessian(96, seed=8)
        dj, dt = _solve(kw, W, H)
        et = _aa(W, dt.reconstruct().numpy(), H)
        ej = _aa(W, np.asarray(dj.reconstruct()), H)
        # RTN: the same codes, f32 ulps apart (ERR_ATOL); the LPLR loop's
        # quantized factors round once more per iteration, still on the
        # same codes here
        assert abs(et - ej) <= 1e-4, (et, ej)
        assert dt.errors.keys() == dj.errors.keys()

    def test_diag_hessian_equals_full(self):
        W = _W(9, (32, 64))
        d = np.random.default_rng(9).uniform(0.5, 2, 64).astype(np.float32)
        _, tp = _params()
        a = TC.caldera(tp, torch.from_numpy(W), torch.from_numpy(d),
                       scale_W=False)
        b = TC.caldera(tp, torch.from_numpy(W), torch.from_numpy(np.diag(d)),
                       scale_W=False)
        assert torch.equal(a.reconstruct(), b.reconstruct())

    def test_scale_w(self):
        W = 3 * _W(10, (32, 48))
        jp, tp = _params()
        dj = JC.caldera(jp, jnp.asarray(W))
        dt = TC.caldera(tp, torch.from_numpy(W))
        # an f32 mean of 1536 squares in another order: ulps
        assert dt.global_scale == pytest.approx(dj.global_scale, rel=1e-6)
        assert _rel(W, dt.reconstruct().numpy()) == pytest.approx(
            _rel(W, np.asarray(dj.reconstruct())), abs=1e-4)

    def test_rand_svd_close_to_exact(self):
        # the reference's bound (tests/test_caldera.py): the draws come
        # from another generator, so only the errors can be compared
        W = _W(11, (96, 64))
        _, exact = _params(rank=16, iters=2)
        _, rand = _params(rank=16, iters=2, rand_svd=True)
        e1 = _rel(W, TC.caldera(exact, torch.from_numpy(W),
                                scale_W=False).reconstruct().numpy())
        e2 = _rel(W, TC.caldera(rand, torch.from_numpy(W), scale_W=False,
                                generator=torch.Generator().manual_seed(1))
                  .reconstruct().numpy())
        assert abs(e1 - e2) < 0.05

    def test_batched_equals_serial(self):
        Ws = np.stack([_W(12 + i, (32, 48)) for i in range(3)])
        Hs = np.stack([_hessian(48, seed=i) for i in range(3)])
        _, tp = _params(q_update="ldlq")
        Q, L, R, errors, scales = TC.caldera_batched(
            tp, torch.from_numpy(Ws), torch.from_numpy(Hs), scale_W=False)
        assert errors.shape == (3, 2, 2)
        for b in range(3):
            q, l, r, e = TC.caldera_solve(tp, torch.from_numpy(Ws[b]),
                                          torch.from_numpy(Hs[b]), 1.0)
            # the same calls in the same order
            assert torch.equal(Q[b], q) and torch.equal(L[b] @ R[b], l @ r)
            np.testing.assert_array_equal(errors[b].numpy(),
                                          np.float32(e))
        jp, _ = _params(q_update="ldlq")
        jQ, jL, jR, jerr, _ = JC.caldera_batched(
            jp, jnp.asarray(Ws), jnp.asarray(Hs), scale_W=False)
        # LDLQ through each item's own U: LDLQ_RTOL
        for b in range(3):
            et = _aa(Ws[b], (Q[b] + L[b] @ R[b]).numpy(), Hs[b])
            ej = _aa(Ws[b], np.asarray(jQ[b] + jL[b] @ jR[b]), Hs[b])
            assert abs(et - ej) <= LDLQ_RTOL * ej

    @pytest.mark.parametrize("route", ["full", "identity", "not_aware"])
    def test_prep_matches_reference(self, route):
        # the Hessian preprocessing on H's device (the port has no host
        # eigh route): the regularized H, H^{1/2} and the LDLQ factor
        # against the reference's prep; f32 eigh and Cholesky of two
        # libraries at condition ~10: 1e-4 of H^{1/2}, 1e-5 of U
        n = 64
        H = _hessian(n, seed=13)
        identity = route == "identity"
        if identity:
            H = np.eye(n, dtype=np.float32)
        jp, tp = _params(q_update="ldlq", sigma_reg=1e-2,
                         activation_aware_LR=route != "not_aware")
        jH, jS, _, _, jU = JC._caldera_prep(jp, jnp.asarray(H), identity)
        tH, tS, teig, tU = TC.caldera_prep(tp, torch.from_numpy(H), identity)
        for t, j, tol in ((tH, jH, 1e-5), (tS, jS, 1e-4), (tU, jU, 1e-5)):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=tol * np.abs(j).max())
        assert teig.eigenvalues.shape == (n,)

    def test_unknown_q_update_raises(self):
        _, tp = _params(q_update="gptq")
        with pytest.raises(ValueError, match="q_update"):
            TC.caldera(tp, torch.from_numpy(_W(14, (16, 16))))


class TestLDLQ:
    def test_identity_is_per_row_rtn_bit_exact(self):
        A = _W(20, (64, 96))
        U = np.eye(96, dtype=np.float32)
        got = TC.ldlq_quantize(torch.from_numpy(A), torch.from_numpy(U),
                               3).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JC.ldlq_quantize(jnp.asarray(A), jnp.asarray(U),
                                             3)))
        scale = np.maximum(np.abs(A).max(1, keepdims=True), 1e-12) / 3
        np.testing.assert_array_equal(
            got, np.clip(np.round(A / scale), -3, 3) * scale)
        # and inside the solver (identity Hessian: U = I exactly), whose
        # first Q update rounds W itself (later ones round W - L @ R, and
        # the two SVD routines' L @ R differ in ulps): the same codes; the
        # values an ulp apart, as XLA compiles the jitted solver's w /
        # (absmax / maxq) as w * maxq / absmax
        W = _W(21, (32, 64))
        dj, dt = _solve(dict(q_update="ldlq", Q_bits=4, iters=1), W)
        scale = np.maximum(np.abs(W).max(1, keepdims=True), 1e-12) / 7
        np.testing.assert_array_equal(np.round(dt.Q.numpy() / scale),
                                      np.round(np.asarray(dj.Q) / scale))
        np.testing.assert_allclose(dt.Q.numpy(), np.asarray(dj.Q),
                                   rtol=2 * F32_EPS, atol=0)

    def test_precompute(self):
        H = _hessian(64, seed=22)
        U = TC.ldlq_precompute(torch.from_numpy(H)).numpy()
        assert np.array_equal(U, np.triu(U))
        Hinv = np.linalg.inv(H.astype(np.float64))
        np.testing.assert_allclose(U.T @ U, Hinv, rtol=0,
                                   atol=1e-4 * np.abs(Hinv).max())
        # condition ~10: the f32 Cholesky pairs agree to 1e-5 relative
        np.testing.assert_allclose(
            U, np.asarray(JC.ldlq_precompute(jnp.asarray(H))), rtol=0,
            atol=1e-5 * np.abs(U).max())

    @pytest.mark.parametrize("bits", [2, 4])
    def test_same_u_same_codes(self, bits):
        A, H = _W(23, (48, 128)), _hessian(128, seed=23)
        U = TC.ldlq_precompute(torch.from_numpy(H))
        got = TC.ldlq_quantize(torch.from_numpy(A), U, bits).numpy()
        ref = np.asarray(JC.ldlq_quantize(jnp.asarray(A),
                                          jnp.asarray(U.numpy()), bits))
        # one error per column fed back as single products, and one
        # rank-panel update per panel: the same codes (read: all equal)
        scale = np.maximum(np.abs(A).max(1, keepdims=True), 1e-12) / (
            2 ** (bits - 1) - 1)
        same = np.round(got / scale) == np.round(ref / scale)
        assert same.mean() >= 0.99
        # LDLQ beats RTN on the correlated H
        maxq = 2 ** (bits - 1) - 1
        rtn = np.clip(np.round(A / scale), -maxq, maxq) * scale
        assert _aa(A, got, H) < 0.95 * _aa(A, rtn, H)

    @pytest.mark.parametrize("panel", [8, 32, 64])
    def test_panels_agree_with_unblocked(self, panel):
        A, H = _W(24, (32, 128)), _hessian(128, seed=24)
        U = TC.ldlq_precompute(torch.from_numpy(H))
        full = TC.ldlq_quantize(torch.from_numpy(A), U, 4, panel=1).numpy()
        blk = TC.ldlq_quantize(torch.from_numpy(A), U, 4,
                               panel=panel).numpy()
        # the trailing update summed per panel instead of per column: f32
        # reassociation, which can round a code the other way downstream
        # (the reference's bounds, tests/test_ldlq.py)
        assert np.mean(full == blk) > 0.97
        assert abs(_aa(A, full, H) - _aa(A, blk, H)) <= 0.02 * _aa(A, full,
                                                                   H)

    def test_e8p_sweep(self):
        A, H = _W(25, (32, 64)), _hessian(64, seed=25)
        U = TC.ldlq_precompute(torch.from_numpy(H))
        got = TC.ldlq_quantize_e8p(torch.from_numpy(A), U)
        ref = np.asarray(JC.ldlq_quantize_e8p(jnp.asarray(A),
                                              jnp.asarray(U.numpy())))
        # the per-row scales come from the block RMS (an f32 mean, ulps
        # apart), so compare the objective: LDLQ_RTOL
        assert abs(_aa(A, got.numpy(), H) - _aa(A, ref, H)) <= (
            LDLQ_RTOL * _aa(A, ref, H))
        # every 8-group of a row is a codeword at the row's scale
        codes, s = TLat.e8p_recover_codes(got)
        torch.testing.assert_close(TLat.e8p_dequantize_blocks(codes, s), got,
                                   rtol=2 * F32_EPS, atol=0)
        full = TC.ldlq_quantize_e8p(torch.from_numpy(A), U, panel=8)
        assert abs(_aa(A, full.numpy(), H) - _aa(A, got.numpy(), H)) <= (
            0.02 * _aa(A, full.numpy(), H))
        with pytest.raises(ValueError, match="% 8"):
            TC.ldlq_quantize_e8p(torch.zeros((4, 12)), torch.eye(12))

    def test_caldera_ldlq_matches_and_beats_rtn(self):
        W, H = _W(26, (64, 128)), _hessian(128, seed=26)
        dj, dt = _solve(dict(q_update="ldlq", Q_bits=2, rank=8), W, H)
        et = _aa(W, dt.reconstruct().numpy(), H)
        ej = _aa(W, np.asarray(dj.reconstruct()), H)
        assert abs(et - ej) <= LDLQ_RTOL * ej, (et, ej)
        _, rtn = _solve(dict(q_update="rtn", Q_bits=2, rank=8), W, H)
        assert et < _aa(W, rtn.reconstruct().numpy(), H)

    def test_caldera_e8p(self):
        W, H = _W(27, (32, 64)), _hessian(64, seed=27)
        for q_update in ("rtn", "ldlq"):
            dj, dt = _solve(dict(q_update=q_update,
                                 quant_factory_Q=("e8p", 64)), W, H)
            et = _aa(W, dt.reconstruct().numpy(), H)
            ej = _aa(W, np.asarray(dj.reconstruct()), H)
            assert abs(et - ej) <= LDLQ_RTOL * ej, (q_update, et, ej)


class TestQuantizedCodes:
    @pytest.mark.parametrize("case", ["uniform", "ldlq", "e8p", "e8p-ldlq"])
    def test_round_trip(self, case):
        W, H = _W(30, (32, 64)), _hessian(64, seed=30)
        kw = dict(L_bits=4, R_bits=4, quant_factory_LR=("uniform",
                                                        "global"))
        if case in ("ldlq", "e8p-ldlq"):
            kw["q_update"] = "ldlq"
        if case.startswith("e8p"):
            kw["quant_factory_Q"] = ("e8p", 64)
        _, tp = _params(**kw)
        d = TC.caldera(tp, torch.from_numpy(W), torch.from_numpy(H),
                       scale_W=False)
        codes = d.quantized_codes(tp)
        c, s = codes["Q"]
        if case.startswith("e8p"):
            rec = TLat.e8p_dequantize_blocks(c, s).reshape(d.Q.shape)
        elif case == "ldlq":
            rec = c.float() * s
        else:
            rec = TB.uniform_dequantize_blocks(c, s, 2).reshape(d.Q.shape)
        # on the grid already: the values come back to an f32 rounding
        torch.testing.assert_close(rec, d.Q, rtol=4 * F32_EPS, atol=1e-7)
        for name, mat in (("L", d.L.T), ("R", d.R)):
            lc, ls = codes[name]
            torch.testing.assert_close(
                TB.uniform_dequantize_blocks(lc, ls, 4).reshape(mat.shape),
                mat, rtol=4 * F32_EPS, atol=1e-7)
        _, tp16 = _params()
        codes16 = d.quantized_codes(tp16)
        assert codes16["L"] is None and codes16["R"] is None
