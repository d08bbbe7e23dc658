"""Block quantizer family, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.quant.
quantizers``: :class:`QuantizedTensor`, :class:`BlockQuantizer` (methods
``uniform``, ``nf4``, ``nf4_true``, ``nf4_meanstd``, ``nf2``, ``bbint4``,
``bbint2`` and ``e8p``, over flat row-major blocks or one ``"global"``
block) and the hashable :class:`QuantizerFactory` that ``CalderaParams``
carries. Codes stay unpacked; :meth:`QuantizedTensor.packed_codes` packs
them losslessly in the reference's byte layout. E8P codes are int32 here
(the reference's are uint16; the values are the same).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import blockquant as bq
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import lattice
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import packing

_METHODS = ("uniform", "nf4", "nf4_true", "nf4_meanstd", "nf2",
            "bbint4", "bbint2", "e8p")
_BITWIDTHS = (2, 3, 4, 8, 16)


@dataclasses.dataclass
class QuantizedTensor:
    """Quantized 2-D matrix: ``codes`` (num_blocks, block_size) unpacked (or
    (num_blocks, block_size / 8) for e8p), per-block ``scale`` / ``zero``,
    and the outlier mask and values of the bbint methods."""

    codes: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor] = None
    outlier_mask: Optional[torch.Tensor] = None
    outlier_values: Optional[torch.Tensor] = None
    shape: Tuple[int, int] = (0, 0)
    num_bits: int = 4
    method: str = "uniform"

    def num_outliers(self) -> int:
        if self.outlier_mask is None:
            return 0
        return int(self.outlier_mask.sum())

    def packed_codes(self) -> torch.Tensor:
        """Byte-packed codes (lossless; the reference's layout)."""
        if self.method == "e8p":
            return self.codes      # one 16-bit index per 8 weights
        if self.method == "uniform":
            if self.num_bits in (2, 4):
                return packing.pack_signed(self.codes, self.num_bits)
            return self.codes
        if self.num_bits in (2, 4):
            return packing.pack_codes(self.codes, self.num_bits)
        return self.codes

    def storage_bits(self) -> int:
        """Storage footprint in bits: codes, fp16 scales (and zeros), and
        each outlier as an fp32 value and two int32 indices."""
        m, n = self.shape
        nb = int(self.scale.shape[0])
        bits = m * n * self.num_bits + nb * 16
        if self.zero is not None:
            bits += nb * 16
        return bits + self.num_outliers() * (32 + 64)


class BlockQuantizer:
    """Quantizer over flat row-major blocks."""

    def __init__(self, num_bits: int = 2, method: str = "uniform",
                 block_size: Union[int, str] = 64):
        if num_bits not in _BITWIDTHS:
            raise ValueError(f"bit-width {num_bits} not supported")
        method = method.lower()
        if method not in _METHODS:
            raise NotImplementedError(
                f"quantization method {method!r} not supported")
        only = {"nf4": 4, "nf4_true": 4, "nf4_meanstd": 4, "nf2": 2,
                "bbint4": 4, "bbint2": 2, "e8p": 2}.get(method)
        if only is not None and num_bits != only:
            raise ValueError(f"{method} supports only {only} bits")
        self.num_bits = num_bits
        self.method = method
        self.block_size = block_size

    def _resolve_block_size(self, W: torch.Tensor) -> int:
        if self.block_size == "global":
            return int(W.numel())
        return int(self.block_size)

    def quantize(self, W: torch.Tensor) -> QuantizedTensor:
        if W.dim() != 2:
            raise ValueError(f"expected a 2-D matrix, got {W.dim()}-D input")
        blocks, shape = bq.blockify(W.float(), self._resolve_block_size(W))
        meta = dict(shape=shape, num_bits=self.num_bits, method=self.method)
        if self.method == "uniform":
            codes, absmax = bq.uniform_quantize_blocks(blocks, self.num_bits)
            return QuantizedTensor(codes=codes, scale=absmax, **meta)
        if self.method in ("nf4", "nf4_true", "nf2"):
            idx, scale = bq.nf_quantize_blocks(
                blocks, bq.nf_levels(self.method, blocks.device))
            return QuantizedTensor(codes=idx, scale=scale, **meta)
        if self.method == "nf4_meanstd":
            idx, mean, std = bq.nf_meanstd_quantize_blocks(
                blocks, bq.nf_levels(self.method, blocks.device))
            return QuantizedTensor(codes=idx, scale=std, zero=mean, **meta)
        if self.method == "e8p":
            codes, scale = lattice.e8p_quantize_blocks(blocks)
            return QuantizedTensor(codes=codes, scale=scale, **meta)
        q = bq.affine_outlier_quantize_blocks(blocks, self.num_bits)
        return QuantizedTensor(codes=q.codes, scale=q.scales,
                               zero=q.block_min, outlier_mask=q.outlier_mask,
                               outlier_values=q.outlier_values, **meta)

    def dequantize(self, qt: QuantizedTensor) -> torch.Tensor:
        if qt.method == "uniform":
            out = bq.uniform_dequantize_blocks(qt.codes, qt.scale,
                                               qt.num_bits)
        elif qt.method in ("nf4", "nf4_true", "nf2"):
            out = bq.nf_dequantize_blocks(
                qt.codes, qt.scale, bq.nf_levels(qt.method, qt.codes.device))
        elif qt.method == "nf4_meanstd":
            out = bq.nf_meanstd_dequantize_blocks(
                qt.codes, qt.zero, qt.scale,
                bq.nf_levels(qt.method, qt.codes.device))
        elif qt.method == "e8p":
            out = lattice.e8p_dequantize_blocks(qt.codes, qt.scale)
        else:
            out = bq.affine_outlier_dequantize_blocks(bq.AffineOutlierQuant(
                codes=qt.codes, block_min=qt.zero, scales=qt.scale,
                outlier_mask=qt.outlier_mask,
                outlier_values=qt.outlier_values))
        return bq.unblockify(out, qt.shape)

    def quantize_dequantize(self, W: torch.Tensor) -> torch.Tensor:
        """Fused round trip (what the CALDERA inner loop uses)."""
        return bq.quantize_dequantize(W.float(), self.num_bits, self.method,
                                      self._resolve_block_size(W))

    def quantize_block(self, W: torch.Tensor):
        qt = self.quantize(W)
        return qt.codes, qt.scale, qt.shape

    def dequantize_block(self, codes, params, shape):
        return self.dequantize(QuantizedTensor(
            codes=codes, scale=params, shape=tuple(shape),
            num_bits=self.num_bits, method=self.method))

    def __repr__(self):
        return (f"BlockQuantizer(num_bits={self.num_bits}, "
                f"method={self.method!r}, block_size={self.block_size!r})")


@dataclasses.dataclass(frozen=True)
class QuantizerFactory:
    """Quantizer settings carried inside ``CalderaParams`` (frozen, so
    hashable)."""

    method: str = "uniform"
    block_size: Union[int, str] = 64

    def get_quantizer(self, num_bits: int, device: Any = None
                      ) -> BlockQuantizer:
        del device  # placement follows the tensors; kept for API parity
        return BlockQuantizer(num_bits=num_bits, method=self.method,
                              block_size=self.block_size)

    def __str__(self):
        return (f"QuantizerFactory(method={self.method}, "
                f"block_size={self.block_size})")
