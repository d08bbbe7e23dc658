"""Low-rank linear algebra helpers of the CALDERA solver, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.decomp.
lowrank``: least squares by QR plus a tiny ridge and a triangular solve,
truncated and randomized SVD, the closed-form rank-constrained regression
that sets the low-rank factors, and the regularized eigendecomposition and
symmetric square root of a Hessian. Every routine runs ``torch.linalg`` on
the device of its inputs (cuSOLVER / cuBLAS on the card, LAPACK on the
CPU), in f32 with TF32 off (the callers' :func:`_device.resolve_device`).

SVD and eigh signs, and the order inside near-degenerate subspaces, differ
between LAPACK builds and cuSOLVER: compare products (``L @ R``,
``H^{1/2}``) and errors, not the factors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class EighResult(NamedTuple):
    eigenvalues: torch.Tensor    # (n,)
    eigenvectors: torch.Tensor   # (n, n), columns are eigenvectors


def lstsq_qr(A: torch.Tensor, B: torch.Tensor,
             ridge: float = 1e-10) -> torch.Tensor:
    """``argmin_X ||A @ X - B||_F`` for tall ``A`` (n, r) and ``B`` (n, k),
    by reduced QR; the ridge on R's diagonal keeps the solve finite when
    ``A`` is rank-deficient."""
    Q, R = torch.linalg.qr(A, mode="reduced")
    Rr = R + ridge * torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    return torch.linalg.solve_triangular(Rr, Q.T @ B, upper=True)


def truncated_svd(Y: torch.Tensor, rank: int):
    """Thin SVD truncated to ``rank``: ``(U_r, S_r, Vh_r)``."""
    U, S, Vh = torch.linalg.svd(Y, full_matrices=False)
    return U[:, :rank], S[:rank], Vh[:rank, :]


def randomized_svd(Y: torch.Tensor, rank: int,
                   generator: Optional[torch.Generator] = None,
                   oversample: Optional[int] = None, n_iter: int = 2):
    """Halko-style randomized range finder (``2 * rank`` columns by default,
    ``n_iter`` subspace iterations) and a small SVD. The test matrix is
    drawn from ``generator``, on ``Y``'s device."""
    m, n = Y.shape
    q = min(2 * rank if oversample is None else rank + oversample, min(m, n))
    Omega = torch.randn((n, q), generator=generator, dtype=Y.dtype,
                        device=Y.device)
    Z = Y @ Omega
    for _ in range(n_iter):
        Z = Y @ (Y.T @ Z)
    Q, _ = torch.linalg.qr(Z, mode="reduced")
    Ub, S, Vh = torch.linalg.svd(Q.T @ Y, full_matrices=False)
    U = Q @ Ub
    return U[:, :rank], S[:rank], Vh[:rank, :]


def rank_constrained_regression(
        residual: torch.Tensor, H_sqrt: torch.Tensor, eigH: EighResult,
        rank: int, data_aware: bool = True, rand_svd: bool = False,
        generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form ``min_{L,R} ||(residual - L @ R) H^{1/2}||_F``.

    Data-aware: SVD of ``residual @ H^{1/2} @ V`` in the Hessian's
    eigenbasis, then ``R`` un-whitened by ``diag(1/sqrt(eigvals)) @ V^T``.
    Otherwise a plain truncated SVD split as ``sqrt(S)`` on both sides.
    """
    def svd(Y):
        if rand_svd:
            return randomized_svd(Y, rank, generator)
        return truncated_svd(Y, rank)

    if data_aware:
        V, lam = eigH.eigenvectors, eigH.eigenvalues
        U, S, Vh = svd(residual @ H_sqrt @ V)
        R = (S[:, None] * Vh) * (1.0 / torch.sqrt(lam))[None, :]
        return U, R @ V.T
    U, S, Vh = svd(residual)
    sq = torch.sqrt(S)
    return U * sq[None, :], sq[:, None] * Vh


def regularized_eigh(H: torch.Tensor, sigma_reg: float):
    """Symmetrize and eigendecompose ``H``; if its smallest eigenvalue is
    below ``sigma_reg``, shift ``H`` and the eigenvalues up to it. Returns
    ``(H, EighResult)``."""
    H = (H + H.T) / 2.0
    eigvals, eigvecs = torch.linalg.eigh(H)
    shift = torch.clamp(sigma_reg - eigvals.min(), min=0.0)
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    return H + shift * eye, EighResult(eigvals + shift, eigvecs)


def hessian_sqrt(eigH: EighResult) -> torch.Tensor:
    """Symmetric square root ``V diag(sqrt(lambda)) V^T``."""
    V = eigH.eigenvectors
    return (V * torch.sqrt(eigH.eigenvalues)[None, :]) @ V.T
