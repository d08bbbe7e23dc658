"""CALDERA alternating solver, in PyTorch: ``W ~= Q + L @ R`` in low
precision.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.decomp.
caldera``, with the same numerical spec:

- the activation-aware objective ``||(W - Q - L R) H^{1/2}||_F`` with the
  symmetric Hessian square root;
- the LPLR update: the closed-form rank-constrained regression, then
  (for quantized factors) alternating least squares + quantization of L
  and R, keeping the best inner iterate by whitened residual norm;
- the Q update: round-to-nearest of ``W - L R`` with the Q quantizer
  (``"rtn"``), or LDLQ error feedback through the Hessian (``"ldlq"``;
  per-row uniform grid, or 8-column E8P blocks for an e8p Q factory);
- the error ``sqrt(tr(E H E^T) / tr(W H W^T))`` after every sub-update,
  and the best iterate over the alternation, a snapshot eligible once every
  component was updated.

The alternation is a plain Python loop over tensors on the device of ``W``
(cuSOLVER eigh, SVD, QR and Cholesky on the card); randomness
(``rand_svd``) comes from an explicit ``torch.Generator``. The LDLQ sweep is
sequential by column: about ten small launches per column, plus one
rank-``panel`` update of the trailing columns per panel.

Where this differs from the reference by design: its TPU-memory routes are
gone. ``ldlq_precompute`` inverts the Cholesky factor in one call (no
chunked ``cho_solve``), and the eigendecomposition always runs on the
tensors' device (the reference moves it to host LAPACK at n >= 8192 on a
TPU, or on request through ``host_eigh``; the port has no host route).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.decomp import lowrank as lr
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import blockquant as bq
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import lattice
from ee274_convexcaldera_llm_quantization_tpu_torch.quant.quantizers import (
    QuantizerFactory)


@dataclasses.dataclass(frozen=True)
class CalderaParams:
    """Parameters of the CALDERA decomposition (the reference's fields and
    defaults)."""

    compute_quantized_component: bool = True
    compute_low_rank_factors: bool = True
    Q_bits: int = 2
    L_bits: int = 2
    R_bits: int = 2
    rank: int = 64
    iters: int = 20
    lplr_iters: int = 5
    activation_aware_LR: bool = True
    update_order: Tuple[str, ...] = ("Q", "LR")
    quant_factory_Q: QuantizerFactory = dataclasses.field(
        default_factory=lambda: QuantizerFactory(block_size="global"))
    quant_factory_LR: QuantizerFactory = dataclasses.field(
        default_factory=lambda: QuantizerFactory(block_size="global"))
    rand_svd: bool = False
    sigma_reg: float = 0.0
    # "rtn": round-to-nearest of the residual with the Q quantizer; "ldlq":
    # sequential error feedback through H on a per-row uniform grid (per-row
    # RTN exactly when H = I)
    q_update: str = "rtn"


@dataclasses.dataclass
class CalderaDecomposition:
    """Result of a CALDERA solve."""

    Q: torch.Tensor = None
    L: torch.Tensor = None
    R: torch.Tensor = None
    W: torch.Tensor = None
    global_scale: float = 1.0
    errors: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def reconstruct(self) -> torch.Tensor:
        """Dense ``W_hat = global_scale * (Q + L @ R)``."""
        return self.global_scale * (self.Q + self.L @ self.R)

    def quantized_codes(self, params: CalderaParams):
        """Integer codes and scales of each component, re-derived from the
        dequantized values (each already on its quantizer's grid): ``{"Q":
        (codes, scales), "L": ..., "R": ...}``, None for 16-bit factors.
        e8p recovers each block's scale exactly from the grid; LDLQ's per-row
        uniform grid is exact whenever a row's largest code survived the
        sweep."""
        out = {}
        if params.quant_factory_Q.method == "e8p":
            if params.q_update == "ldlq":
                bs = self.Q.shape[1]
            elif params.quant_factory_Q.block_size == "global":
                bs = self.Q.numel()
            else:
                bs = int(params.quant_factory_Q.block_size)
            blocks, _ = bq.blockify(self.Q.float(), bs)
            out["Q"] = lattice.e8p_recover_codes(blocks)
        elif params.q_update == "ldlq":
            maxq = 2 ** (params.Q_bits - 1) - 1
            absmax = self.Q.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
            scale = absmax / maxq
            codes = torch.clamp(torch.round(self.Q / scale), -maxq, maxq)
            out["Q"] = (codes.to(torch.int8), scale)
        else:
            qt = params.quant_factory_Q.get_quantizer(
                params.Q_bits).quantize(self.Q)
            out["Q"] = (qt.codes, qt.scale)
        for name, mat, bits in (("L", self.L.T, params.L_bits),
                                ("R", self.R, params.R_bits)):
            if bits >= 16:
                out[name] = None
            else:
                qt = params.quant_factory_LR.get_quantizer(bits).quantize(mat)
                out[name] = (qt.codes, qt.scale)
        return out


def _quantize_qd(A: torch.Tensor, bits: int,
                 factory: QuantizerFactory) -> torch.Tensor:
    if bits >= 16:
        return A
    bs = (A.numel() if factory.block_size == "global"
          else int(factory.block_size))
    return bq.quantize_dequantize(A, bits, factory.method, bs)


def _aa_error(W: torch.Tensor, H: torch.Tensor,
              W_hat: torch.Tensor) -> torch.Tensor:
    """``sqrt(tr(E H E^T) / tr(W H W^T))`` with ``E = W_hat - W``."""
    E = W_hat - W
    return torch.sqrt(((E @ H) * E).sum() / ((W @ H) * W).sum())


def _update_LR(params: CalderaParams, residual: torch.Tensor,
               H_sqrt: torch.Tensor, eigH: lr.EighResult,
               generator: Optional[torch.Generator]):
    """LPLR on the residual ``W - Q``."""
    L, R = lr.rank_constrained_regression(
        residual, H_sqrt, eigH, params.rank,
        data_aware=params.activation_aware_LR, rand_svd=params.rand_svd,
        generator=generator)
    if params.L_bits >= 16 and params.R_bits >= 16:
        return L, R
    RH = H_sqrt if params.activation_aware_LR else torch.eye(
        residual.shape[1], dtype=residual.dtype, device=residual.device)
    bestL, bestR, best_err = L, R, float("inf")
    B = (residual @ RH).T                                   # (n, m)
    for _ in range(params.lplr_iters):
        # L-step: min_L ||L (R Hs) - residual Hs||_F
        L = lr.lstsq_qr((R @ RH).T, B).T
        L = _quantize_qd(L.T, params.L_bits, params.quant_factory_LR).T
        # R-step: min_R ||L R - residual||_F
        R = _quantize_qd(lr.lstsq_qr(L, residual), params.R_bits,
                         params.quant_factory_LR)
        err = float(torch.linalg.norm((residual - L @ R) @ H_sqrt))
        if err < best_err:
            bestL, bestR, best_err = L, R, err
    return bestL, bestR


def _residual(params: CalderaParams, W, L, R) -> torch.Tensor:
    return W - L @ R if params.compute_low_rank_factors else W


def _update_Q(params: CalderaParams, W, L, R) -> torch.Tensor:
    """Round-to-nearest quantization of the low-rank residual."""
    return _quantize_qd(_residual(params, W, L, R), params.Q_bits,
                        params.quant_factory_Q)


def ldlq_precompute(H: torch.Tensor) -> torch.Tensor:
    """Upper-triangular ``U`` with ``U^T U = H^{-1}`` for the LDLQ sweeps.

    ``H`` is regularized by ``1e-6`` of its mean diagonal (plus 1e-12) so
    the Cholesky succeeds on rank-deficient calibration Hessians; the
    inverse comes from the Cholesky factor in one call, symmetrized, and
    ``U`` is the transpose of its Cholesky factor.
    """
    n = H.shape[0]
    d = torch.diagonal(H).mean()
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    Lc = torch.linalg.cholesky(H + (1e-6 * d + 1e-12) * eye)
    Hinv = torch.cholesky_inverse(Lc)
    Hinv = (Hinv + Hinv.T) / 2
    return torch.linalg.cholesky(Hinv).T


def _resolve_panel(n: int, panel: int) -> int:
    """Largest divisor of ``n`` that is <= ``panel``."""
    p = min(panel, n)
    while n % p:
        p -= 1
    return p


def _sweep(A: torch.Tensor, U: torch.Tensor, P: int, step: int,
           quantize) -> torch.Tensor:
    """Panel-blocked sequential error feedback (GPTQ's lazy batches).

    Columns go in blocks of ``step`` inside panels of ``P``: ``quantize(blk,
    c)`` rounds block columns ``c .. c + step - 1``, the block's error,
    solved against ``U``'s diagonal block, updates the rest of the panel,
    and the trailing columns get one rank-``P`` update per panel (exact by
    linearity).
    """
    m, n = A.shape
    Awork = A.clone()
    Q = torch.empty_like(A)
    for c0 in range(0, n, P):
        Ap = Awork[:, c0:c0 + P]
        Up = U[c0:c0 + P, c0:c0 + P]
        Errs = torch.empty((m, P), dtype=A.dtype, device=A.device)
        for j in range(0, P, step):
            blk = Ap[:, j:j + step]
            q = quantize(blk, c0 + j)
            if step == 1:
                err = (blk - q) / Up[j, j]
            else:
                err = torch.linalg.solve_triangular(
                    Up[j:j + step, j:j + step].T, (blk - q).T,
                    upper=False).T
            Ap[:, j + step:] -= err @ Up[j:j + step, j + step:]
            Ap[:, j:j + step] = q
            Errs[:, j:j + step] = err
        Q[:, c0:c0 + P] = Ap
        if c0 + P < n:
            Awork[:, c0 + P:] -= Errs @ U[c0:c0 + P, c0 + P:]
    return Q


def ldlq_quantize(A: torch.Tensor, U: torch.Tensor, bits: int,
                  panel: int = 256) -> torch.Tensor:
    """Sequential error-feedback quantization (the GPTQ / LDLQ sweep).

    Column ``i`` is rounded to the per-row uniform grid (scales: per-row
    absmax of ``A`` over ``2^(bits-1) - 1``, fixed before the sweep, codes
    clipped) and its error propagates into the later columns through ``U``
    (:func:`ldlq_precompute`). With ``H = I`` this is per-row RTN.
    """
    maxq = 2 ** (bits - 1) - 1
    scale = A.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / maxq

    def rtn(w, _):
        return torch.clamp(torch.round(w / scale), -maxq, maxq) * scale

    return _sweep(A, U, _resolve_panel(A.shape[1], panel), 1, rtn)


def ldlq_quantize_e8p(A: torch.Tensor, U: torch.Tensor,
                      panel: int = 256) -> torch.Tensor:
    """Block LDLQ with the E8 lattice codebook (QuIP#'s quantizer).

    Columns go in 8-wide blocks, each jointly rounded to per-row-scaled
    E8P codewords (scales from the lattice scale search on ``A``, fixed
    through the sweep); the within-block 8x8 metric is taken as identity.
    """
    m, n = A.shape
    if n % 8:
        raise ValueError(f"LDLQ-e8p needs columns % 8 == 0, got {n}")
    _, s = lattice.e8p_quantize_blocks(A)                 # (m, 1) scales
    cb = lattice.codebook_on(A.device)
    P = _resolve_panel(n, panel)
    if P % 8:
        P = 8

    def encode(blk, _):
        return lattice.e8p_decode(lattice.e8p_encode(blk / s, cb), cb) * s

    return _sweep(A, U, P, 8, encode)


def _update_Q_ldlq(params: CalderaParams, W, L, R, U) -> torch.Tensor:
    residual = _residual(params, W, L, R)
    if params.quant_factory_Q.method == "e8p":
        return ldlq_quantize_e8p(residual, U)
    return ldlq_quantize(residual, U, params.Q_bits)


def caldera_prep(params: CalderaParams, H: torch.Tensor,
                 identity_hessian: bool = False):
    """Hessian preprocessing on ``H``'s device: ``(H, H_sqrt, eigH,
    U_ldlq)``."""
    n = H.shape[0]
    dev = H.device
    H = H.float()
    needs_eigh = not identity_hessian and params.activation_aware_LR
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    if not needs_eigh:
        H_sqrt = H if not params.activation_aware_LR else eye
        eigH = lr.EighResult(torch.ones(n, device=dev), eye)
        if identity_hessian and params.activation_aware_LR:
            H = eye
    else:
        H, eigH = lr.regularized_eigh(H, params.sigma_reg)
        H_sqrt = lr.hessian_sqrt(eigH)
    U_ldlq = None
    if params.q_update == "ldlq":
        U_ldlq = eye if identity_hessian else ldlq_precompute(H)
    return H, H_sqrt, eigH, U_ldlq


def caldera_core(params: CalderaParams, W: torch.Tensor, H: torch.Tensor,
                 H_sqrt: torch.Tensor, eigH: lr.EighResult,
                 U_ldlq: Optional[torch.Tensor], global_scale: float,
                 generator: Optional[torch.Generator] = None):
    """The alternation: returns ``(Q, L, R, errors)``, the best snapshot
    and the error after each sub-update, ``errors[i][j]`` for iteration
    ``i`` and ``update_order[j]``."""
    if params.q_update not in ("rtn", "ldlq"):
        raise ValueError(f"unknown q_update {params.q_update!r}")
    m, n = W.shape
    dev = W.device
    W = W.float() / torch.tensor(global_scale, dtype=torch.float32,
                                 device=dev)
    Q = torch.zeros((m, n), dtype=torch.float32, device=dev)
    L = torch.zeros((m, params.rank), dtype=torch.float32, device=dev)
    R = torch.zeros((params.rank, n), dtype=torch.float32, device=dev)
    best, min_err = (Q, L, R), float("inf")
    n_upd = len(params.update_order)
    errors = [[float("inf")] * n_upd for _ in range(params.iters)]
    for i in range(params.iters):
        for j, mtx in enumerate(params.update_order):
            if mtx == "LR" and params.compute_low_rank_factors:
                L, R = _update_LR(params, W - Q, H_sqrt, eigH, generator)
            elif mtx == "Q" and params.compute_quantized_component:
                if params.q_update == "ldlq":
                    Q = _update_Q_ldlq(params, W, L, R, U_ldlq)
                else:
                    Q = _update_Q(params, W, L, R)
            err = float(_aa_error(W, H, Q + L @ R))
            errors[i][j] = err
            # a snapshot may win only once every component was updated
            if err < min_err and (i > 0 or j == n_upd - 1):
                best, min_err = (Q, L, R), err
    return (*best, errors)


def caldera_solve(params: CalderaParams, W: torch.Tensor, H: torch.Tensor,
                  global_scale: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  identity_hessian: bool = False):
    """Prep then alternation on ``W``'s device: ``(Q, L, R, errors)``."""
    resolve_device(W.device)
    prep = caldera_prep(params, H.to(W.device), identity_hessian)
    return caldera_core(params, W, *prep, global_scale, generator)


def _hessian(H, W: torch.Tensor):
    """``(H (n, n) f32 on W's device, is_identity)``; None is the identity
    and a 1-D H a diagonal."""
    n = W.shape[1]
    if H is None:
        return torch.eye(n, dtype=torch.float32, device=W.device), True
    H = torch.as_tensor(H, dtype=torch.float32).to(W.device)
    if H.dim() == 1:
        H = torch.diag(H)
    eye = torch.eye(H.shape[0], dtype=torch.float32, device=W.device)
    identity = (H.shape[0] == H.shape[1]
                and bool(torch.allclose(H, eye, rtol=1e-5, atol=1e-8)))
    return H, identity


def caldera(quant_params: CalderaParams, W, H=None, *, scale_W: bool = True,
            generator: Optional[torch.Generator] = None
            ) -> CalderaDecomposition:
    """Run CALDERA on ``W`` (m, n), on its device.

    ``H`` is the input second moment (n, n), its diagonal (n,), or None for
    the identity (the Frobenius objective). Returns the best decomposition
    over all sub-updates.
    """
    W = torch.as_tensor(W).float()
    H, identity = _hessian(H, W)
    global_scale = (float(torch.sqrt((W * W).mean())) if scale_W else 1.0)
    Q, L, R, errors = caldera_solve(quant_params, W, H, global_scale,
                                    generator, identity_hessian=identity)
    err_dict = {mtx: [errors[i][j] for i in range(quant_params.iters)]
                for j, mtx in enumerate(quant_params.update_order)}
    return CalderaDecomposition(
        Q=Q, L=L, R=R,
        W=W / torch.tensor(global_scale, dtype=torch.float32,
                           device=W.device),
        global_scale=global_scale, errors=err_dict)


def caldera_batched(quant_params: CalderaParams, Ws, Hs, *,
                    scale_W: bool = True,
                    generator: Optional[torch.Generator] = None):
    """Solve a stack of same-shape matrices, one after another on their
    device: ``Ws`` (B, m, n), ``Hs`` (B, n, n) or (B, n) diagonals. Each
    item is the serial :func:`caldera_solve` (non-identity prep). Returns
    ``(Q, L, R, errors, scales)`` stacked on the leading axis."""
    Ws = torch.as_tensor(Ws).float()
    Hs = torch.as_tensor(Hs, dtype=torch.float32).to(Ws.device)
    if Hs.dim() == 2:
        Hs = torch.diag_embed(Hs)
    if scale_W:
        scales = torch.sqrt((Ws * Ws).mean(dim=(1, 2)))
    else:
        scales = torch.ones(Ws.shape[0], dtype=torch.float32,
                            device=Ws.device)
    out = [caldera_solve(quant_params, Ws[b], Hs[b], float(scales[b]),
                         generator) for b in range(Ws.shape[0])]
    Q, L, R = (torch.stack([o[k] for o in out]) for k in range(3))
    errors = torch.tensor([o[3] for o in out], dtype=torch.float32)
    return Q, L, R, errors, scales
