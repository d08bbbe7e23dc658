"""Compressed linear-layer parameter store and application, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.
compressed`` (serving half): the same containers with the same field names,
holding tensors instead of JAX arrays, and the same quantizers.
:func:`apply_linear` serves :class:`DenseLinear` and :class:`Int8Linear`;
the other serving modes are still to be ported.
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


def apply_linear(lin: Linear, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ W.T (+ b)`` for a dense or int8 linear; ``x`` (..., in).

    The int8 linear runs :func:`ops.kernels.int8_matmul` (its CUDA kernel
    for CUDA tensors). Compressed and other linears are not ported yet.
    """
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if isinstance(lin, DenseLinear):
        y = x2.to(torch.bfloat16).float() @ lin.w.to(torch.bfloat16).float().T
    elif isinstance(lin, Int8Linear):
        y = K.int8_matmul(x2, lin.w8, lin.scales)
    elif isinstance(lin, CalderaLinear):
        raise NotImplementedError(
            f"apply_linear for a flat CalderaLinear (mode {lin.mode!r}) is not "
            "ported yet (ROADMAP.md, Queue B items 6-7 and Queue A item 4)")
    else:
        raise NotImplementedError(
            f"apply_linear for {type(lin).__name__} is not ported yet "
            "(ROADMAP.md, Queue A item 15)")
    if lin.b is not None:
        y = y + lin.b[None, :]
    return y.reshape(*shape[:-1], y.shape[-1])
