"""Compressed linear-layer parameter store and application, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.
compressed`` (serving half): the same containers with the same field names,
holding tensors instead of JAX arrays, the same quantizers, and
:func:`compress_linear` for the uniform quantizer and the E8P lattice.
:func:`apply_linear` serves :class:`DenseLinear`, :class:`Int8Linear` and
:class:`CalderaLinear` in both serving modes, each through its kernel on
the card ("w4a8": the flat W4A8 matmul; "grouped": the grouped bf16
matmul), the trainable fake-quantized :class:`QATLinear` (plain f32 dots,
straight-through gradients by :func:`ste_quantize`) and the Hadamard-rotated
:class:`RotatedLinear` (FWHTs around its inner linear's kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import lattice


@dataclasses.dataclass
class DenseLinear:
    w: torch.Tensor                       # (out, in)
    b: Optional[torch.Tensor] = None      # (out,)

    @property
    def shape(self):
        return tuple(self.w.shape)


@dataclasses.dataclass
class CalderaLinear:
    """``W ~= global_scale * (Q + L @ R)`` with Q bit-packed (flat, or
    layer-stacked on a leading axis).

    ``mode`` "w4a8": per-row weight scales ``(out, 1)`` and dynamic int8
    activations; "grouped": per-(row, group) scales.
    """

    packed: torch.Tensor                  # (out, in * bits / 8) uint8
    scales: torch.Tensor                  # (out, in / group) f32
    L: torch.Tensor                       # (out, rank) bf16, or int8 codes
    R: torch.Tensor                       # (rank, in) bf16, or int8 codes
    global_scale: torch.Tensor            # () f32
    b: Optional[torch.Tensor] = None      # (out,)
    L_scale: Optional[torch.Tensor] = None    # (out, 1) f32 for int8 L
    R_scale: Optional[torch.Tensor] = None    # (rank, 1) f32 for int8 R
    num_bits: int = 4
    group_size: int = 256
    out_features: int = 0
    in_features: int = 0
    mode: str = "grouped"
    q_method: str = "uniform"
    grid_bits: int = 0

    @property
    def shape(self):
        return (self.out_features, self.in_features)

    def factors(self) -> tuple:
        """Dense bf16 (L, R) regardless of storage dtype."""
        L, R = self.L, self.R
        if self.L_scale is not None:
            L = (L.float() * self.L_scale).to(torch.bfloat16)
        if self.R_scale is not None:
            R = (R.float() * self.R_scale).to(torch.bfloat16)
        return L, R

    def materialize(self) -> torch.Tensor:
        """Dense f32 reconstruction ``gs * (Q + L @ R)`` (tests and error
        reports only)."""
        if self.mode == "w4a8":
            maxq = 2 ** (self.num_bits - 1) - 1
            Q = ((K.unpack_codes(self.packed, self.num_bits).float() - maxq)
                 * self.scales)
        else:
            Q = K.dequant_serving_xla(self.packed, self.scales, self.num_bits,
                                      self.group_size).float()
        L, R = self.factors()
        return self.global_scale * (Q + L.float() @ R.float())


@dataclasses.dataclass
class Int8Linear:
    """Plain int8 row-quantized linear (the lm_head at serve time):
    ``W ~= scales * w8``, served by the int8 matmul kernel."""

    w8: torch.Tensor                      # (out, in) int8
    scales: torch.Tensor                  # (out, 1) f32
    b: Optional[torch.Tensor] = None      # (out,)

    @property
    def shape(self):
        return tuple(self.w8.shape)


def ste_quantize(W: torch.Tensor, num_bits: int,
                 group_size: Optional[int] = None) -> torch.Tensor:
    """Fake-quantize with a straight-through gradient.

    Forward: symmetric absmax quantize-dequantize at ``num_bits``, per row
    when ``group_size`` is None (the w4a8 grid, ``kernels.pack_rowscale``)
    or per (row, group) (``pack_for_serving``), in f32. Backward: identity
    (``W + (q(W) - W).detach()``); absmax never clips, so nothing gates the
    gradient.
    """
    maxq = 2 ** (num_bits - 1) - 1
    Wf = W.float()
    if group_size is None:
        g = Wf
    else:
        N, Kin = Wf.shape
        if Kin % group_size:
            raise ValueError(f"K={Kin} not divisible by group {group_size}")
        g = Wf.reshape(N, Kin // group_size, group_size)
    absmax = g.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    scale = absmax / maxq
    q = (torch.clamp(torch.round(g / scale), -maxq, maxq) * scale).reshape(
        Wf.shape)
    return Wf + (q - Wf).detach()


@dataclasses.dataclass
class QATLinear:
    """Trainable fake-quantized CALDERA linear:
    ``W ~= global_scale * (ste_quantize(Wq) + L @ R)`` with an f32 latent
    ``Wq`` re-quantized on every forward and f32 factors
    (``models.qat`` converts to and from the packed form)."""

    Wq: torch.Tensor                      # (out, in) f32
    L: torch.Tensor                       # (out, rank) f32
    R: torch.Tensor                       # (rank, in) f32
    global_scale: torch.Tensor            # () f32
    b: Optional[torch.Tensor] = None      # (out,)
    num_bits: int = 4
    group_size: Optional[int] = None      # None: one scale per row
    mode: str = "w4a8"

    @property
    def shape(self):
        return tuple(self.Wq.shape)

    def effective_weight(self) -> torch.Tensor:
        """The dense f32 weight the forward sees (``global_scale`` outside
        the gradient)."""
        q = ste_quantize(self.Wq, self.num_bits, self.group_size)
        return self.global_scale.detach() * (q + self.L @ self.R)

    def materialize(self) -> torch.Tensor:
        return self.effective_weight()


@dataclasses.dataclass
class RotatedLinear:
    """A CalderaLinear served in a Hadamard-rotated basis: ``W = H1 W' H2``
    with orthonormal Hadamard rotations on the power-of-two sides
    (``rot_out``: output features, ``rot_in``: input features); ``inner``
    holds the packed ``W'``. Forward: ``y = H1 (W' (H2 x)) + b``, the
    rotations as FWHTs; the bias lies outside them."""

    inner: CalderaLinear
    b: Optional[torch.Tensor] = None
    rot_in: bool = True
    rot_out: bool = True

    @property
    def shape(self):
        return self.inner.shape

    def materialize(self) -> torch.Tensor:
        W = self.inner.materialize().float()
        if self.rot_out:
            W = K.fwht(W, axis=0) / K._sqrt_size(W.shape[0], 1, W.device)
        if self.rot_in:
            W = K.fwht(W, axis=1) / K._sqrt_size(W.shape[1], 1, W.device)
        return W


Linear = Union[DenseLinear, CalderaLinear, Int8Linear, QATLinear,
               RotatedLinear]


def quantize_linear_int8(lin: DenseLinear) -> Int8Linear:
    """Row-wise int8 quantization of a dense linear (e.g. the lm_head)."""
    w8, scales = K.quantize_int8_rowwise(lin.w)
    return Int8Linear(w8=w8, scales=scales, b=lin.b)


def quantize_factors_int8(lin: CalderaLinear) -> CalderaLinear:
    """Convert a CalderaLinear's bf16 L/R factors to int8 + per-row scales
    (flat or layer-stacked)."""
    if lin.L_scale is not None:
        return lin
    L8, Ls = K.quantize_int8_rowwise(lin.L)
    R8, Rs = K.quantize_int8_rowwise(lin.R)
    return dataclasses.replace(lin, L=L8, R=R8, L_scale=Ls, R_scale=Rs)


def compress_linear(W: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                    num_bits: int, global_scale=1.0,
                    group_size: Optional[int] = None,
                    bias: Optional[torch.Tensor] = None,
                    mode: str = "grouped",
                    q_method: str = "uniform") -> CalderaLinear:
    """Pack a CALDERA decomposition ``(Q, L, R)`` into serving form.

    ``W`` is the Q component (N, K): "w4a8" packs it with one scale per row
    (a 3-bit grid in the 4-bit container), "grouped" with one scale per
    (row, group). ``L``/``R`` are stored as bf16.

    ``q_method="e8p"`` (``mode="w4a8"`` only) quantizes ``W`` per row with
    the E8 lattice codebook and repacks it losslessly as int4 with per-row
    scale ``s/2`` (``ops.lattice.e8p_pack_rowscale``); the per-row offset
    ``s/4`` rides as one more rank-1 term, ``L`` gaining the column
    ``offsets / global_scale`` and ``R`` a row of ones. ``num_bits`` is then
    4 (the resident form); the information rate is 2 bits per weight.
    """
    N, Kin = W.shape
    if q_method == "e8p":
        if mode != "w4a8":
            raise ValueError("e8p serving requires mode='w4a8'")
        packed, half_scales, offsets = lattice.e8p_pack_rowscale(W)
        gs = torch.as_tensor(global_scale, dtype=torch.float32,
                             device=W.device)
        L_aug = torch.cat([L.to(torch.bfloat16),
                           (offsets / gs).to(torch.bfloat16)], dim=1)
        R_aug = torch.cat([R.to(torch.bfloat16),
                           torch.ones((1, Kin), dtype=torch.bfloat16,
                                      device=W.device)], dim=0)
        return CalderaLinear(
            packed=packed, scales=half_scales, L=L_aug, R=R_aug,
            global_scale=gs, b=bias, num_bits=4, group_size=Kin,
            out_features=N, in_features=Kin, mode="w4a8", q_method="e8p")
    if q_method != "uniform":
        raise ValueError(f"unknown serving q_method {q_method!r}")
    if num_bits == 3 and mode != "w4a8":
        raise ValueError("3-bit serving (int4-container grid) requires "
                         "mode='w4a8'")
    if mode == "w4a8":
        packed, scales = K.pack_rowscale(W, num_bits)
        group_size = Kin
        serve_bits = K.container_bits(num_bits)
    else:
        group_size = K.resolve_group(num_bits, Kin, group_size)
        packed, scales = K.pack_for_serving(W, num_bits, group_size)
        serve_bits = num_bits
    return CalderaLinear(
        packed=packed, scales=scales, L=L.to(torch.bfloat16),
        R=R.to(torch.bfloat16),
        global_scale=torch.as_tensor(global_scale, dtype=torch.float32,
                                     device=W.device),
        b=bias, num_bits=serve_bits, group_size=group_size, out_features=N,
        in_features=Kin, mode=mode,
        grid_bits=num_bits if serve_bits != num_bits else 0)


def apply_linear(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ W.T (+ b)``; ``x`` (..., in).

    The int8 linear runs :func:`ops.kernels.int8_matmul`; a CalderaLinear
    runs, as in the reference, "w4a8": :func:`ops.kernels.
    quantized_matmul_w4a8` plus the factor dots; "grouped" with int8
    factors: :func:`ops.kernels.quantized_matmul` plus the factor dots;
    "grouped" with bf16 factors: :func:`ops.kernels.fused_qlr_matmul`. Each
    kernel runs on the card for CUDA tensors and as its plain version for
    CPU tensors. A QATLinear is an f32 dot with its effective weight; a
    RotatedLinear runs its inner linear between FWHTs.
    """
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if isinstance(lin, DenseLinear):
        y = x2.to(torch.bfloat16).float() @ lin.w.to(torch.bfloat16).float().T
    elif isinstance(lin, QATLinear):
        y = x2.float() @ lin.effective_weight().T
    elif isinstance(lin, RotatedLinear):
        u = x2.float()
        if lin.rot_in:
            u = K.fwht(u, axis=-1) / K._sqrt_size(u.shape[-1], 1, u.device)
        y = apply_linear(lin.inner, u)
        if lin.rot_out:
            y = K.fwht(y, axis=-1) / K._sqrt_size(y.shape[-1], 1, y.device)
    elif isinstance(lin, Int8Linear):
        y = K.int8_matmul(x2, lin.w8, lin.scales)
    elif isinstance(lin, CalderaLinear) and lin.mode == "w4a8":
        yq = K.quantized_matmul_w4a8(x2, lin.packed, lin.scales, lin.num_bits)
        ylr = K.low_rank_matmul(x2, lin.L, lin.R, lin.L_scale, lin.R_scale)
        y = (yq + ylr) * lin.global_scale
    elif isinstance(lin, CalderaLinear) and (lin.L_scale is not None
                                             or lin.R_scale is not None):
        yq = K.quantized_matmul(x2, lin.packed, lin.scales, lin.num_bits,
                                lin.group_size)
        ylr = K.low_rank_matmul(x2, lin.L, lin.R, lin.L_scale, lin.R_scale)
        y = (yq + ylr) * lin.global_scale
    else:
        y = K.fused_qlr_matmul(x2, lin.packed, lin.scales, lin.L, lin.R,
                               lin.num_bits, lin.group_size,
                               lin.global_scale)
    if lin.b is not None:
        y = y + lin.b[None, :]
    return y.reshape(*shape[:-1], y.shape[-1])
