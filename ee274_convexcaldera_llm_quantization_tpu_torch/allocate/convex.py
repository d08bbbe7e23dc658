"""Convex-CALDERA: convex low-rank + low-precision compression with
certificates (effective rank, average bits, a true duality gap), in
PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.allocate.
convex``, in float64 on the tensors' device (the reference runs numpy in
float64; on the card the SVDs and eigh are cuSOLVER calls). The penalty
form

    min_{L,R}  1/2 ||(W - L - R) H^{1/2}||_F^2 + mu ||L||_*
               + lambda max(||R||_F^2 / kappa, q_floor)

(``b* = min(b_max, B_tot / p)``, ``q_floor = c e^{-k b*}``) is solved by
FISTA on L with R marginalized (the effective spectrum
``d = theta ev / (ev + theta)``, ``theta = 2 lambda / kappa``), each step a
singular-value thresholding; the constrained form (``||L||_* <= tau*``)
by projected FISTA. The exact R-step, the all-in-R candidate and the
Fenchel-dual gap follow, as in the reference.

The loop reads a scalar back to the host only at the reference's
10-iteration convergence check: the thresholding and the projection keep
their ranks on the device (a zero singular value adds an exact zero).
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)

F64 = torch.float64


@dataclasses.dataclass
class ConvexCalderaParams:
    """Parameters (the reference's ``ConvexCalderaParams``)."""

    B_tot: float = 2.0
    b_min: float = 2.0
    b_max: float = 16.0
    # exactly one of (tau_star, mu) applies: mu is the penalty form's
    # default, tau_star switches to the constrained form
    tau_star: Optional[float] = None
    mu: Optional[float] = 0.1
    lambda_reg: float = 0.01
    k: float = 1.0
    discrete_bits: Tuple[int, ...] = (2, 3, 4, 8, 16)
    solver_tol: float = 1e-6
    max_outer_iters: int = 60
    fista_iters: int = 40
    tolerance: float = 0.05
    quantize_factors: bool = False
    factor_bits: int = 16


@dataclasses.dataclass
class ConvexCalderaDecomposition:
    """Result with its certificates (tensors on the solve's device)."""

    L_star: torch.Tensor
    R_star: torch.Tensor
    W_compressed: torch.Tensor
    b_star: torch.Tensor
    b_discrete: torch.Tensor
    avg_bit_width: float
    effective_rank: float
    duality_gap: float
    residual_norm: float
    solve_time: float
    solver_status: str
    objective_value: float
    group_info: Dict = dataclasses.field(default_factory=dict)


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=F64)


# ---------------------------------------------------------------------------
# Step 1: calibration (Hessian, sensitivity, rate-distortion constant)
# ---------------------------------------------------------------------------

def compute_hessian_and_sensitivities(W: torch.Tensor, H=None,
                                      calibration_data=None):
    """PSD-clamp H, return (H, H^{1/2}, eigvals, eigvecs, kappa, c): H from
    the argument (1-D: a diagonal), else the Gram of the calibration data,
    else the identity; eigenvalues clamped at 1e-8; ``kappa = ||W||_F``;
    ``c = 0.1 Var(W)``. On ``W``'s device, in f64."""
    dev = W.device
    n = W.shape[1]
    if H is None:
        if calibration_data is None:
            H = torch.eye(n, dtype=F64, device=dev)
        else:
            X = _f64(calibration_data, dev)
            H = X.T @ X
    H = _f64(H, dev)
    if H.dim() == 1:
        H = torch.diag(H)
    H = (H + H.T) / 2
    eigvals, eigvecs = torch.linalg.eigh(H)
    eigvals = eigvals.clamp_min(1e-8)
    H = (eigvecs * eigvals) @ eigvecs.T
    H_sqrt = (eigvecs * torch.sqrt(eigvals)) @ eigvecs.T
    kappa = max(float(torch.linalg.norm(W)), 1e-12)
    c = 0.1 * float(W.var(unbiased=False))
    return H, H_sqrt, eigvals, eigvecs, kappa, c


# ---------------------------------------------------------------------------
# Step 2: the convex solve
# ---------------------------------------------------------------------------

def _h_conj(nrm: float, lam: float, kappa: float, q_floor: float) -> float:
    """Fenchel conjugate of ``h(R) = lam max(||R||^2 / kappa, q_floor)`` at a
    matrix of Frobenius norm ``nrm`` (h is radial: the sup over the
    radius, at the kink ``sqrt(kappa q_floor)`` or on the quadratic
    piece)."""
    if lam <= 0:
        return 0.0 if nrm <= 0 else math.inf
    r0 = math.sqrt(max(kappa * q_floor, 0.0))
    cand = r0 * nrm - lam * q_floor
    r_quad = kappa * nrm / (2.0 * lam)
    if r_quad >= r0:
        cand = max(cand, kappa * nrm ** 2 / (4.0 * lam))
    return cand


def _svt(X: torch.Tensor, thresh: float):
    """Singular value thresholding, ``argmin_Z 1/2||Z-X||^2 + t||Z||_*``;
    returns (Z, the thresholded singular values)."""
    U, s, Vh = torch.linalg.svd(X, full_matrices=False)
    s2 = (s - thresh).clamp_min(0.0)
    return (U * s2) @ Vh, s2


def _project_nuclear_ball(X: torch.Tensor, tau: float):
    """Euclidean projection onto ``{Z : ||Z||_* <= tau}`` by the simplex
    projection of the singular values (X itself when inside)."""
    U, s, Vh = torch.linalg.svd(X, full_matrices=False)
    cssv = torch.cumsum(s, 0) - tau
    ind = torch.arange(1, s.numel() + 1, dtype=F64, device=X.device)
    rho = ((s - cssv / ind > 0) * ind).amax()
    theta = cssv[rho.long() - 1] / rho
    s2 = (s - theta).clamp_min(0.0)
    inside = s.sum() <= tau
    return (torch.where(inside, X, (U * s2) @ Vh),
            torch.where(inside, s, s2))


def _r_step(M: torch.Tensor, eigvals: torch.Tensor, eigvecs: torch.Tensor,
            lam: float, kappa: float, q_floor: float) -> torch.Tensor:
    """Exact R-step, ``argmin_R 1/2 tr((M-R) H (M-R)^T) + lam max(||R||^2 /
    kappa, q_floor)``: the flat, ridge (``R = M V diag(ev / (ev + theta))
    V^T``, ``theta = 2 lam / kappa``) and kink-boundary (bisection on
    theta) candidates, the cheapest returned."""
    Mt = M @ eigvecs
    r0sq = kappa * q_floor

    def ridge(theta):
        return (Mt * (eigvals / (eigvals + theta))) @ eigvecs.T

    def cost(R):
        Et = (M - R) @ eigvecs
        quad = 0.5 * float(((Et * Et) * eigvals).sum())
        return quad + lam * max(float((R * R).sum()) / kappa, q_floor)

    candidates = []
    if float((M * M).sum()) <= r0sq:
        candidates.append(M)
    R_ridge = ridge(2.0 * lam / kappa)
    if float((R_ridge * R_ridge).sum()) >= r0sq - 1e-12:
        candidates.append(R_ridge)
    if not candidates and r0sq > 0:
        lo, hi = 0.0, 2.0 * lam / kappa
        for _ in range(80):
            mid = (lo + hi) / 2
            if float((ridge(mid) ** 2).sum()) > r0sq:
                lo = mid
            else:
                hi = mid
        candidates.append(ridge((lo + hi) / 2))
    if not candidates:
        candidates.append(R_ridge)
    return min(candidates, key=cost)


def _l_step_fista(N: torch.Tensor, L0: torch.Tensor, eigvals: torch.Tensor,
                  eigvecs: torch.Tensor, mu: Optional[float],
                  tau_star: Optional[float], iters: int) -> torch.Tensor:
    """L-step, ``argmin_L 1/2 tr((N-L) H (N-L)^T) + mu||L||_*`` (or s.t.
    ``||L||_* <= tau_star``): FISTA with step ``1 / lambda_max(H)``."""
    step = 1.0 / float(eigvals.max())
    L, Z, t = L0.clone(), L0.clone(), 1.0
    for _ in range(iters):
        grad = ((Z - N) @ eigvecs * eigvals) @ eigvecs.T
        Y = Z - step * grad
        if tau_star is not None:
            L_new, _ = _project_nuclear_ball(Y, tau_star)
        else:
            L_new, _ = _svt(Y, mu * step)
        t_new = (1 + math.sqrt(1 + 4 * t * t)) / 2
        Z = L_new + ((t - 1) / t_new) * (L_new - L)
        L, t = L_new, t_new
    return L


def solve_convex_optimization(W: torch.Tensor, eigvals: torch.Tensor,
                              eigvecs: torch.Tensor, kappa: float, c: float,
                              params: ConvexCalderaParams, p: float = 1.0):
    """Step 2: the reduced convex program in (L, R), on ``W``'s device in
    f64. Returns ``(L_star, R_star, b_star, objective, status,
    duality_gap)``."""
    W = W.to(F64)
    b_star = float(min(params.b_max, params.B_tot / p))
    if b_star < params.b_min:
        warnings.warn("bit budget infeasible: B_tot/p < b_min; clamping")
        b_star = params.b_min
    q_floor = c * math.exp(-params.k * b_star)
    lam = params.lambda_reg
    mu, tau = params.mu, params.tau_star
    if tau is not None:
        mu = None

    def primal(L, R):
        Et = (W - L - R) @ eigvecs
        val = 0.5 * float(((Et * Et) * eigvals).sum())
        if mu is not None:
            val += mu * float(torch.linalg.svdvals(L).sum())
        return val + lam * max(float((R * R).sum()) / kappa, q_floor)

    # R marginalized: for the exact ridge R given L, the smooth part is a
    # quadratic in L with the effective spectrum d (FISTA on L alone; the
    # reference explains why alternating on L and R stalls)
    theta = 2.0 * lam / kappa
    d = theta * eigvals / (eigvals + theta)
    step = 1.0 / float(d.max())
    L = torch.zeros_like(W)
    Z = L.clone()
    t = 1.0
    prev = math.inf
    status = "max_iters"
    for it in range(params.max_outer_iters * params.fista_iters):
        grad = ((Z - W) @ eigvecs * d) @ eigvecs.T
        Y = Z - step * grad
        if tau is not None:
            L_new, _ = _project_nuclear_ball(Y, tau)
        else:
            L_new, _ = _svt(Y, mu * step)
        t_new = (1 + math.sqrt(1 + 4 * t * t)) / 2
        Z = L_new + ((t - 1) / t_new) * (L_new - L)
        L, t = L_new, t_new
        if it % 10 == 9:
            Et = (W - L) @ eigvecs
            obj = 0.5 * float(((Et * Et) * d).sum())
            if abs(prev - obj) <= params.solver_tol * max(1.0, abs(prev)):
                status = "optimal"
                break
            prev = obj

    # the exact R for the final L, and the all-in-R candidate (optimal when
    # q_floor dominates)
    R = _r_step(W - L, eigvals, eigvecs, lam, kappa, q_floor)
    L0 = torch.zeros_like(W)
    R0 = _r_step(W, eigvals, eigvecs, lam, kappa, q_floor)
    if primal(L0, R0) < primal(L, R):
        L, R = L0, R0
    obj = primal(L, R)
    gap = duality_gap(W, L, R, eigvals, eigvecs, kappa, lam, q_floor,
                      mu=mu, tau_star=tau, primal_value=obj)
    return L, R, b_star, obj, status, gap


def duality_gap(W, L, R, eigvals, eigvecs, kappa, lam, q_floor, *,
                mu=None, tau_star=None, primal_value=None) -> float:
    """The Fenchel duality gap at the dual point ``Lambda = (W - L - R) H``
    (scaled into the spectral ball ``||Lambda||_2 <= mu`` in the penalty
    form): ``g(Lambda) = <Lambda, W> - 1/2 tr(Lambda H^{-1} Lambda^T) -
    f1*(Lambda) - h*(||Lambda||_F)``, every term exact, so
    ``primal - g >= primal - optimum``."""
    E = W - L - R
    Lam = (E @ eigvecs * eigvals) @ eigvecs.T
    sig_max = float(torch.linalg.matrix_norm(Lam, ord=2))
    if mu is not None and sig_max > mu > 0:
        Lam = Lam * (mu / sig_max)
        sig_max = mu
    Lt = Lam @ eigvecs
    quad = 0.5 * float(((Lt * Lt) / eigvals).sum())
    g = float((Lam * W).sum()) - quad
    if tau_star is not None:
        g -= tau_star * sig_max
    g -= _h_conj(float(torch.linalg.norm(Lam)), lam, kappa, q_floor)
    if primal_value is None:
        primal_value = math.inf
    return max(primal_value - g, 0.0)


# ---------------------------------------------------------------------------
# Steps 3-6: rounding, factorization, residual quantization, certificates
# ---------------------------------------------------------------------------

def round_bit_allocations(b_star: float, discrete_bits: Sequence[int],
                          B_tot: float, p: float = 1.0) -> int:
    """Step 3: the nearest discrete width, repaired down to the largest
    affordable one."""
    b = min(discrete_bits, key=lambda x: abs(x - b_star))
    if p * b > B_tot:
        valid = [x for x in discrete_bits if p * x <= B_tot]
        b = max(valid) if valid else min(discrete_bits)
    return int(b)


def low_rank_factorization(L_star: torch.Tensor, tau_star: Optional[float],
                           mu: Optional[float], quantize: bool = False,
                           factor_bits: int = 16):
    """Step 4: SVD of L*, the rank by the nuclear-norm budget (constrained)
    or a relative threshold (penalty), a sqrt(S) split, optionally the
    factors quantized uniformly. Returns (Lf, Rf, rank)."""
    U, S, Vh = torch.linalg.svd(L_star, full_matrices=False)
    if tau_star is not None:
        rank = int(torch.searchsorted(torch.cumsum(S, 0),
                                      torch.tensor([tau_star], dtype=F64,
                                                   device=S.device))) + 1
        rank = min(rank, S.numel())
    else:
        s0 = float(S[0]) if S.numel() else 0.0
        rank = int((S > s0 * 1e-6).sum()) if s0 > 0 else 0
    rank = max(rank, 1)
    sq = torch.sqrt(S[:rank])
    Lf = U[:, :rank] * sq
    Rf = sq[:, None] * Vh[:rank, :]
    if quantize:
        maxq = 2 ** (factor_bits - 1) - 1

        def uniform(F):
            sc = F.abs().max()
            if float(sc) > 0:
                return torch.round(F / sc * maxq) / maxq * sc
            return F
        Lf, Rf = uniform(Lf), uniform(Rf)
    return Lf, Rf, float(rank)


def quantize_residual(R_star: torch.Tensor, b: int):
    """Step 5: symmetric uniform quantization of the residual at ``b``
    bits. Returns (dequantized residual, step)."""
    t = float(R_star.abs().max())
    delta = 2 * t / (2 ** b - 1) if b < 16 else t / 2 ** 15
    if delta == 0:
        return torch.zeros_like(R_star), 0.0
    maxv = 2 ** (b - 1) - 1
    R_int = torch.clamp(torch.round(R_star / delta), -maxv, maxv)
    return delta * R_int, delta


def compute_certificates(W, W_compressed, b_discrete, effective_rank,
                         objective_value, duality_gap_value):
    """Step 6: the certificates, with the true gap."""
    residual_norm = float(torch.linalg.norm(W - W_compressed))
    relative_error = residual_norm / max(float(torch.linalg.norm(W)), 1e-12)
    return {
        "avg_bit_width": float(b_discrete),
        "effective_rank": float(effective_rank),
        "residual_norm": residual_norm,
        "relative_error": relative_error,
        "duality_gap": float(duality_gap_value),
        "objective_value": float(objective_value),
    }


# ---------------------------------------------------------------------------
# Step 7: the whole pipeline
# ---------------------------------------------------------------------------

def convex_caldera(W, H=None, calibration_data=None,
                   params: Optional[ConvexCalderaParams] = None,
                   device="cuda") -> ConvexCalderaDecomposition:
    """The whole Convex-CALDERA pipeline on ``device`` in f64. ``W``, ``H``
    and ``calibration_data`` are tensors or numpy arrays."""
    t0 = time.time()
    dev = resolve_device(device)
    if params is None:
        params = ConvexCalderaParams()
    W = _f64(W, dev)
    H_in = None if H is None else _f64(H, dev)

    H, H_sqrt, eigvals, eigvecs, kappa, c = \
        compute_hessian_and_sensitivities(W, H_in, calibration_data)
    L_star, R_star, b_star, obj, status, gap = solve_convex_optimization(
        W, eigvals, eigvecs, kappa, c, params)

    b_discrete = round_bit_allocations(b_star, params.discrete_bits,
                                       params.B_tot)
    Lf, Rf, eff_rank = low_rank_factorization(
        L_star, params.tau_star, params.mu, params.quantize_factors,
        params.factor_bits)
    R_quant, delta = quantize_residual(R_star, b_discrete)
    # the stored form: the factorized L, not the raw L*
    W_compressed = Lf @ Rf + R_quant

    certs = compute_certificates(W, W_compressed, b_discrete, eff_rank, obj,
                                 gap)
    return ConvexCalderaDecomposition(
        L_star=L_star,
        R_star=R_quant,
        W_compressed=W_compressed,
        b_star=torch.tensor([b_star], dtype=F64),
        b_discrete=torch.tensor([b_discrete]),
        avg_bit_width=certs["avg_bit_width"],
        effective_rank=certs["effective_rank"],
        duality_gap=certs["duality_gap"],
        residual_norm=certs["residual_norm"],
        solve_time=time.time() - t0,
        solver_status=status,
        objective_value=certs["objective_value"],
        group_info={"L": Lf, "R_lr": Rf, "delta": delta,
                    "certificates": certs},
    )
