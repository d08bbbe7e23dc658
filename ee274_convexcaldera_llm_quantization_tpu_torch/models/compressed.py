"""Compressed linear-layer parameter store and application, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.
compressed`` (serving half): the same containers with the same field names,
holding tensors instead of JAX arrays, the same quantizers, and
:func:`compress_linear` for the uniform quantizer. :func:`apply_linear`
serves :class:`DenseLinear`, :class:`Int8Linear` and :class:`CalderaLinear`
in both serving modes, each through its kernel on the card ("w4a8": the
flat W4A8 matmul; "grouped": the grouped bf16 matmul); ``QATLinear`` and
``RotatedLinear`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K


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


Linear = Union[DenseLinear, CalderaLinear, Int8Linear]


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
    (row, group). ``L``/``R`` are stored as bf16. Only the uniform
    quantizer is ported; ``q_method="e8p"`` needs the lattice codebook.
    """
    N, Kin = W.shape
    if q_method == "e8p":
        raise NotImplementedError(
            "q_method='e8p' (the E8P lattice repack) is not ported yet "
            "(ROADMAP.md, Queue A item 11: ops/lattice.py)")
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
    CPU tensors.
    """
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if isinstance(lin, DenseLinear):
        y = x2.to(torch.bfloat16).float() @ lin.w.to(torch.bfloat16).float().T
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
    elif isinstance(lin, CalderaLinear):
        y = K.fused_qlr_matmul(x2, lin.packed, lin.scales, lin.L, lin.R,
                               lin.num_bits, lin.group_size,
                               lin.global_scale)
    else:
        raise NotImplementedError(
            f"apply_linear for {type(lin).__name__} is not ported yet "
            "(ROADMAP.md, Queue A item 15)")
    if lin.b is not None:
        y = y + lin.b[None, :]
    return y.reshape(*shape[:-1], y.shape[-1])
