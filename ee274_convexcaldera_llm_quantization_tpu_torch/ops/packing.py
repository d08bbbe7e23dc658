"""Bit packing and unpacking of int4 / int2 codes, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.ops.packing``:
two 4-bit or four 2-bit codes per byte along the last axis, the first code
in the most significant bits, so the bytes equal the reference's. The COO
helpers for the affine-outlier quantizers stay host-side numpy, as there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _factor(num_bits: int, what: str) -> int:
    if num_bits not in (4, 2):
        raise ValueError(f"cannot {what} {num_bits}-bit codes")
    return 8 // num_bits


def pack_codes(codes: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Pack unsigned codes in [0, 2^b - 1] along the last axis (b = 4 or 2;
    8-bit codes are stored as they are). The last axis must be divisible by
    ``8 // num_bits``."""
    if num_bits == 8:
        return codes.to(torch.uint8)
    factor = _factor(num_bits, "pack")
    if codes.shape[-1] % factor != 0:
        raise ValueError(
            f"last axis {codes.shape[-1]} not divisible by pack factor "
            f"{factor}")
    g = codes.to(torch.uint8).reshape(*codes.shape[:-1],
                                      codes.shape[-1] // factor, factor)
    packed = torch.zeros(g.shape[:-1], dtype=torch.uint8, device=g.device)
    for i in range(factor):
        packed |= g[..., i] << (num_bits * (factor - 1 - i))
    return packed


def unpack_codes(packed: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; returns uint8 codes."""
    if num_bits == 8:
        return packed.to(torch.uint8)
    factor = _factor(num_bits, "unpack")
    mask = (1 << num_bits) - 1
    parts = [(packed >> (num_bits * (factor - 1 - i))) & mask
             for i in range(factor)]
    out = torch.stack(parts, dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * factor)


def pack_signed(codes: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Pack signed codes in [-(2^(b-1)-1), 2^(b-1)-1] as offset binary."""
    offset = 2 ** (num_bits - 1) - 1
    return pack_codes(codes.to(torch.int32) + offset, num_bits)


def unpack_signed(packed: torch.Tensor, num_bits: int) -> torch.Tensor:
    offset = 2 ** (num_bits - 1) - 1
    return unpack_codes(packed, num_bits).to(torch.int32) - offset


def mask_to_coo(mask: np.ndarray,
                values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense outlier mask to COO ``(indices, values)`` (host numpy)."""
    mask = np.asarray(mask)
    values = np.asarray(values)
    return np.argwhere(mask), values[mask]


def coo_to_mask(shape: Tuple[int, ...], idx: np.ndarray,
                vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mask = np.zeros(shape, dtype=bool)
    values = np.zeros(shape, dtype=np.float32)
    if len(idx):
        mask[tuple(idx.T)] = True
        values[tuple(idx.T)] = vals
    return mask, values
