"""PyTorch port, bit allocation: ``allocate/convex.py`` (Convex-CALDERA in
f64), ``allocate/multigroup.py`` and ``models/surgery.py``'s
``compress_model_with_budget``, against the JAX reference on the CPU.

The reference's Convex-CALDERA is numpy in float64, the port's torch in
float64: the same FISTA iterations, SVDs from two LAPACK builds."""

import dataclasses

import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.allocate import convex as JV
from ee274_convexcaldera_llm_quantization_tpu.allocate import (
    multigroup as JM)
from ee274_convexcaldera_llm_quantization_tpu.models import surgery as JS
from ee274_convexcaldera_llm_quantization_tpu_torch.allocate import (
    convex as TV)
from ee274_convexcaldera_llm_quantization_tpu_torch.allocate import (
    multigroup as TM)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    surgery as TS)

from test_torch_fused import _one_torch_thread  # noqa: F401 (a fixture)
from test_torch_surgery import (LDLQ_RTOL, _check_reports, _cp, _hessians,
                                _models)

# Convex-CALDERA on 64 x 48, f64 both sides: the objective within 1e-9
# relative, L and R within 1e-7 of ||W||, the certified gap within 1e-6 of
# the objective in both packages.
OBJ_RTOL, LR_RTOL, GAP_RTOL = 1e-9, 1e-7, 1e-6


def _problem(seed=0, m=64, n=48):
    """A rank-4 signal plus noise, and a diagonal Hessian."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((m, 4)) @ rng.standard_normal((4, n))
         + 0.1 * rng.standard_normal((m, n)))
    return W, rng.uniform(0.5, 2.0, n)


# name -> params: the penalty form with a rank-4 L, and the constrained
# form with its nuclear-norm ball active
_FORMS = {"penalty": dict(mu=1e-3),
          "constrained": dict(tau_star=50.0, lambda_reg=1.0)}


@pytest.mark.parametrize("form", list(_FORMS))
def test_solve_convex_optimization(form):
    W, h = _problem()
    jp, tp = JV.ConvexCalderaParams(**_FORMS[form]), TV.ConvexCalderaParams(
        **_FORMS[form])
    _, _, ev, V, kappa, c = JV.compute_hessian_and_sensitivities(W, h)
    L, R, b, obj, status, gap = JV.solve_convex_optimization(
        W, ev, V, kappa, c, jp)
    Wt = torch.tensor(W)
    _, _, tev, tV, tkappa, tc = TV.compute_hessian_and_sensitivities(
        Wt, torch.tensor(h))
    assert tkappa == pytest.approx(kappa, rel=1e-14)
    assert tc == pytest.approx(c, rel=1e-12)
    tL, tR, tb, tobj, tstatus, tgap = TV.solve_convex_optimization(
        Wt, tev, tV, tkappa, tc, tp)
    assert (tstatus, tb) == (status, b) and status == "optimal"
    assert abs(tobj - obj) <= OBJ_RTOL * obj
    scale = np.linalg.norm(W)
    assert np.linalg.norm(tL.numpy() - L) <= LR_RTOL * scale
    assert np.linalg.norm(tR.numpy() - R) <= LR_RTOL * scale
    assert np.linalg.matrix_rank(L) >= 3
    assert gap <= GAP_RTOL * obj and tgap <= GAP_RTOL * tobj


def test_solver_pieces():
    """The thresholding, the nuclear-ball projection (inside and outside),
    the R-step's regimes and the conjugate, piece by piece."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((12, 9))
    ev = rng.uniform(0.5, 2.0, 9)
    V = np.linalg.qr(rng.standard_normal((9, 9)))[0]
    tX, tev, tV = (torch.tensor(a) for a in (X, ev, V))
    for t in (0.5, 2.0):
        assert np.allclose(TV._svt(tX, t)[0].numpy(), JV._svt(X, t)[0],
                           rtol=0, atol=1e-12)
    for tau in (1.0, 5.0, 1e3):
        j, js = JV._project_nuclear_ball(X, tau)
        t, ts = TV._project_nuclear_ball(tX, tau)
        assert np.allclose(t.numpy(), j, rtol=0, atol=1e-12), tau
        assert np.allclose(ts.numpy()[:len(js)], js, rtol=0, atol=1e-12)
    # the flat (huge q_floor), ridge and kink-boundary regimes
    for lam, kappa, qf in ((0.01, 3.0, 1e6), (0.5, 3.0, 0.0),
                           (0.5, 3.0, 2.0)):
        j = JV._r_step(X, ev, V, lam, kappa, qf)
        t = TV._r_step(tX, tev, tV, lam, kappa, qf)
        assert np.allclose(t.numpy(), j, rtol=0, atol=1e-12), (lam, qf)
    for args in ((0.7, 0.1, 3.0, 0.2), (5.0, 0.1, 3.0, 0.2), (1.0, 0.0, 2.0,
                                                              1.0)):
        assert TV._h_conj(*args) == JV._h_conj(*args)
    jl = JV._l_step_fista(X, np.zeros_like(X), ev, V, 0.3, None, 20)
    tl = TV._l_step_fista(tX, torch.zeros_like(tX), tev, tV, 0.3, None, 20)
    assert np.allclose(tl.numpy(), jl, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mu", [0.1, 1e-3])
def test_convex_caldera(mu):
    """The whole pipeline in the penalty form: certificates equal."""
    W, h = _problem(seed=1)
    j = JV.convex_caldera(W, h, params=JV.ConvexCalderaParams(mu=mu))
    t = TV.convex_caldera(W, h, params=TV.ConvexCalderaParams(mu=mu),
                          device="cpu")
    assert t.b_discrete.tolist() == j.b_discrete.tolist()
    assert t.b_star.tolist() == j.b_star.tolist()
    assert (t.effective_rank, t.avg_bit_width, t.solver_status) == (
        j.effective_rank, j.avg_bit_width, j.solver_status)
    assert t.duality_gap <= GAP_RTOL * t.objective_value
    assert t.objective_value == pytest.approx(j.objective_value,
                                              rel=OBJ_RTOL)
    scale = np.linalg.norm(W)
    assert np.linalg.norm(t.W_compressed.numpy() - j.W_compressed) <= (
        LR_RTOL * scale)
    assert t.group_info["delta"] == pytest.approx(j.group_info["delta"],
                                                  rel=1e-9)


def test_convex_caldera_constrained_rank():
    """The constrained form: the rank is the first index where the
    cumulative singular values of L* reach tau. L* lies on the ball, so
    its sum equals tau to rounding, and every trailing index sits on that
    edge: the ranks may part only at indices whose cumulative sums are
    within rounding of tau (read: 3 against 5); everything else equal."""
    W, h = _problem(seed=0)
    kw = dict(tau_star=50.0, lambda_reg=1.0)
    j = JV.convex_caldera(W, h, params=JV.ConvexCalderaParams(**kw))
    t = TV.convex_caldera(W, h, params=TV.ConvexCalderaParams(**kw),
                          device="cpu")
    assert (t.avg_bit_width, t.solver_status) == (j.avg_bit_width,
                                                  j.solver_status)
    S = np.linalg.svd(j.L_star, compute_uv=False)
    St = torch.linalg.svdvals(t.L_star).numpy()
    assert np.allclose(St, S, rtol=0, atol=1e-10 * S[0])
    lo, hi = sorted((int(j.effective_rank), int(t.effective_rank)))
    edge = np.cumsum(S)[lo - 1:hi - 1]
    assert np.all(np.abs(edge - kw["tau_star"]) <= 1e-12 * kw["tau_star"])
    assert np.sum(S > 1e-9 * S[0]) <= lo


def test_round_and_quantize_residual():
    rng = np.random.default_rng(2)
    R = rng.standard_normal((16, 8))
    for b in (2, 3, 4, 8, 16):
        j, jd = JV.quantize_residual(R, b)
        t, td = TV.quantize_residual(torch.tensor(R), b)
        assert td == jd and np.array_equal(t.numpy(), j), b
    for b_star, B in ((2.0, 2.0), (5.0, 16.0), (7.0, 3.0), (2.6, 2.5)):
        assert TV.round_bit_allocations(b_star, (2, 3, 4, 8, 16), B) == (
            JV.round_bit_allocations(b_star, (2, 3, 4, 8, 16), B))
    z = TV.quantize_residual(torch.zeros((3, 3)), 4)
    assert z[1] == 0.0 and not z[0].any()


# ---------------------------------------------------------------------------
# multigroup
# ---------------------------------------------------------------------------

def _groups(seed, n=9):
    rng = np.random.default_rng(seed)
    return [dict(name=f"g{i}", num_params=int(rng.integers(1000, 50000)),
                 c=float(rng.uniform(0.01, 1.0)), k=float(rng.uniform(0.5,
                                                                      1.5)),
                 weight=float(rng.uniform(0.1, 3.0))) for i in range(n)]


@pytest.mark.parametrize("seed,B", [(0, 3.0), (1, 4.5), (2, 2.0), (3, 9.0)])
def test_multigroup(seed, B):
    specs = _groups(seed)
    jg = [JM.GroupSpec(**s) for s in specs]
    # the port takes tensors as well as floats
    tg = [TM.GroupSpec(**dict(s, c=torch.tensor(s["c"], dtype=torch.float64),
                              weight=torch.tensor(s["weight"],
                                                  dtype=torch.float64)))
          for s in specs]
    for fn, kw in (("allocate_bits_continuous", {}),
                   ("allocate_bits_discrete", dict(menu=(2, 3, 4, 8, 16))),
                   ("allocate_bits_discrete", dict(menu=(2, 4, 8)))):
        j = getattr(JM, fn)(jg, B, **kw)
        t = getattr(TM, fn)(tg, B, **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), fn
    shapes = {f"l{i}": (64 * (i + 1), 96) for i in range(4)}
    var = {f"l{i}": 0.01 * (i + 1) for i in range(4)}
    assert ([dataclasses.asdict(g) for g in TM.groups_from_layers(
        shapes, var, k=0.8)] == [dataclasses.asdict(g) for g in
                                 JM.groups_from_layers(shapes, var, k=0.8)])


# ---------------------------------------------------------------------------
# compress_model_with_budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["hessians", "e8p-at-2bit", "identity"])
def test_compress_model_with_budget(case, _one_torch_thread):
    """TINY, every projection of layer 1 (of both layers without
    Hessians; o and up under e8p): the allocation equal, the reports and
    errors within tests/test_torch_surgery.py's CALDERA tolerances (RTN,
    and 2% where e8p's block RMS can round a code the other way)."""
    jp, tp = _models()
    kw = dict(serving_mode="w4a8")
    if case != "identity":
        kw.update(hessians=_hessians(True), layer_range=(1, 1))
    if case == "e8p-at-2bit":
        kw.update(use_e8p_at_2bit=True, proj_filter=("o_proj", "up_proj"))
    B = 3.0
    jq, jr, ja = JS.compress_model_with_budget(jp, _cp("jax", iters=1), B,
                                               **kw)
    tq, tr, ta = TS.compress_model_with_budget(tp, _cp("torch", iters=1), B,
                                               **kw)
    assert ta.bits == ja.bits
    assert len(set(ta.bits.values())) > 1     # a real mix
    assert ta.avg_bits == ja.avg_bits and ta.budget_used == ja.budget_used
    # c = 0.1 Var(W): the reference's numpy f32 variance, the port's f64
    for f in ("total_distortion", "duality_gap"):
        assert getattr(ta, f) == pytest.approx(getattr(ja, f), rel=1e-6)
    if case == "e8p-at-2bit":
        _check_reports(jr, tr, rtol=LDLQ_RTOL)
    else:
        _check_reports(jr, tr)
    for i, (jl, tl) in enumerate(zip(jq.layers, tq.layers)):
        for proj in TS.PROJ_NAMES:
            a, b = getattr(jl, proj), getattr(tl, proj)
            bits = ta.bits.get(f"layers.{i}.{proj}")
            if bits is None:
                assert a is getattr(jp.layers[i], proj)
                assert b is getattr(tp.layers[i], proj)
                continue
            assert type(a).__name__ == type(b).__name__
            assert (b.num_bits, b.q_method) == (a.num_bits, a.q_method)
            assert b.num_bits == (4 if case == "e8p-at-2bit" and bits == 2
                                  else bits)


def test_budget_refuses_e8p_outside_w4a8():
    _, tp = _models()
    with pytest.raises(ValueError, match="w4a8"):
        TS.compress_model_with_budget(tp, _cp("torch", iters=1), 2.0,
                                      use_e8p_at_2bit=True,
                                      proj_filter=("o_proj",))
