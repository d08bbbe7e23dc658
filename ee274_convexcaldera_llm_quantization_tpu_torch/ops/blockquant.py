"""Blockwise quantization primitives, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.ops.blockquant``:
pure functions on ``(num_blocks, block_size)`` tensors (a matrix flattened
row-major and cut into blocks), each running on the device of its input.

- uniform: symmetric absmax per block to ``2^(b-1) - 1`` levels;
- NF: absmax-scaled codebooks (the reference's legacy NF4 table, the exact
  bitsandbytes NF4 table ``nf4_true``, NF2) and the mean/std-standardized
  ``nf4_meanstd`` (population std);
- affine min/max with 6-sigma outlier extraction (``bbint4``/``bbint2``;
  Bessel-corrected std), outliers kept exactly;
- ``e8p``: the E8 lattice codebook (``ops.lattice``).

``torch.round`` rounds half to even, as ``jnp.round`` does; the ``_EPS``
floors are the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import lattice

_EPS = 1e-8

# Legacy NF4 table used by the reference's canonical quantizer.
NF4_LEVELS_LEGACY = np.array(
    [-1.334, -1.0, -0.784, -0.617, -0.476, -0.347, -0.226, -0.112,
     0.0, 0.112, 0.226, 0.347, 0.476, 0.617, 0.784, 1.0], dtype=np.float32)

# Exact bitsandbytes NF4 codebook (normal-float, 16 asymmetric levels).
NF4_LEVELS_TRUE = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0], dtype=np.float32)

NF2_LEVELS = np.array([-0.8165, -0.3333, 0.3333, 0.8165], dtype=np.float32)


def blockify(W: torch.Tensor,
             block_size: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Flatten row-major and reshape to ``(num_blocks, block_size)``."""
    if W.numel() % block_size != 0:
        raise ValueError(
            f"matrix with {W.numel()} elements is not divisible by block "
            f"size {block_size}")
    return W.reshape(-1, block_size), tuple(W.shape)


def unblockify(blocks: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    return blocks.reshape(shape)


def _absmax(blocks: torch.Tensor) -> torch.Tensor:
    return blocks.abs().amax(dim=1, keepdim=True).clamp_min(_EPS)


# ---------------------------------------------------------------------------
# Uniform (symmetric absmax)
# ---------------------------------------------------------------------------

def uniform_quantize_blocks(blocks: torch.Tensor, num_bits: int):
    """Per-block symmetric absmax quantization. Returns ``(codes, absmax)``,
    codes int8 for b <= 8 else int16."""
    absmax = _absmax(blocks)
    maxq = 2 ** (num_bits - 1) - 1
    codes = torch.round(blocks / absmax * maxq)
    return codes.to(torch.int8 if num_bits <= 8 else torch.int16), absmax


def uniform_dequantize_blocks(codes: torch.Tensor, absmax: torch.Tensor,
                              num_bits: int) -> torch.Tensor:
    maxq = 2 ** (num_bits - 1) - 1
    return codes.float() / maxq * absmax


# ---------------------------------------------------------------------------
# NF (normal-float codebook)
# ---------------------------------------------------------------------------

def nf_levels(method: str, device="cpu") -> torch.Tensor:
    if method in ("nf4", "nf4_meanstd"):
        table = NF4_LEVELS_LEGACY
    elif method == "nf4_true":
        table = NF4_LEVELS_TRUE
    elif method == "nf2":
        table = NF2_LEVELS
    else:
        raise ValueError(f"unknown NF method {method!r}")
    return torch.from_numpy(table).to(device)


def _level_index(scaled: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Number of midpoints between sorted levels that each value exceeds:
    the nearest level's index."""
    thresholds = (levels[:-1] + levels[1:]) / 2.0
    return (scaled[..., None] > thresholds).sum(dim=-1).to(torch.uint8)


def nf_meanstd_quantize_blocks(blocks: torch.Tensor, levels: torch.Tensor):
    """Per-block (mean, population std) standardization, then the NF
    codebook. Returns ``(idx, mean, std)``."""
    mean = blocks.mean(dim=1, keepdim=True)
    std = blocks.std(dim=1, keepdim=True, correction=0).clamp_min(_EPS)
    return _level_index((blocks - mean) / std, levels), mean, std


def nf_meanstd_dequantize_blocks(idx, mean, std, levels):
    return levels[idx.long()] * std + mean


def nf_quantize_blocks(blocks: torch.Tensor, levels: torch.Tensor):
    """Absmax-scaled codebook quantization. Returns ``(uint8 idx, scale)``."""
    scale = _absmax(blocks)
    return _level_index(blocks / scale, levels), scale


def nf_dequantize_blocks(idx, scale, levels):
    return levels[idx.long()] * scale


# ---------------------------------------------------------------------------
# Affine min/max with 6-sigma outlier extraction
# ---------------------------------------------------------------------------

class AffineOutlierQuant(NamedTuple):
    """Affine blockwise codes with outliers as a dense mask + values."""

    codes: torch.Tensor            # (nb, bs) uint8, regular codes
    block_min: torch.Tensor        # (nb, 1) f32
    scales: torch.Tensor           # (nb, 1) f32
    outlier_mask: torch.Tensor     # (nb, bs) bool
    outlier_values: torch.Tensor   # (nb, bs) f32 (zeros where not outlier)


def affine_outlier_quantize_blocks(blocks: torch.Tensor, num_bits: int,
                                   sigma_thresh: float = 6.0
                                   ) -> AffineOutlierQuant:
    """Per-block affine quantization after replacing values more than
    ``sigma_thresh`` Bessel-corrected standard deviations from the block
    mean by the mean; outliers are restored exactly at dequantization."""
    maxq = 2 ** num_bits - 1
    mean = blocks.mean(dim=1, keepdim=True)
    std = blocks.std(dim=1, keepdim=True, correction=1).clamp_min(_EPS)
    mask = (blocks - mean).abs() > sigma_thresh * std
    cleaned = torch.where(mask, mean, blocks)
    bmin = cleaned.amin(dim=1, keepdim=True)
    bmax = cleaned.amax(dim=1, keepdim=True)
    scales = ((bmax - bmin) / maxq).clamp_min(_EPS)
    codes = torch.clamp(torch.round((cleaned - bmin) / scales), 0, maxq)
    return AffineOutlierQuant(
        codes=codes.to(torch.uint8), block_min=bmin, scales=scales,
        outlier_mask=mask,
        outlier_values=torch.where(mask, blocks,
                                   torch.zeros_like(blocks)).float())


def affine_outlier_dequantize_blocks(q: AffineOutlierQuant) -> torch.Tensor:
    dq = q.codes.float() * q.scales + q.block_min
    return torch.where(q.outlier_mask, q.outlier_values, dq)


# ---------------------------------------------------------------------------
# Quantize -> dequantize round trip (the CALDERA inner loop)
# ---------------------------------------------------------------------------

def quantize_dequantize(W: torch.Tensor, num_bits: int, method: str,
                        block_size: int) -> torch.Tensor:
    """One-shot quantize + dequantize of a matrix with any method."""
    blocks, shape = blockify(W.float(), block_size)
    if method == "uniform":
        codes, absmax = uniform_quantize_blocks(blocks, num_bits)
        out = uniform_dequantize_blocks(codes, absmax, num_bits)
    elif method in ("nf4", "nf4_true", "nf2"):
        levels = nf_levels(method, blocks.device)
        idx, scale = nf_quantize_blocks(blocks, levels)
        out = nf_dequantize_blocks(idx, scale, levels)
    elif method == "nf4_meanstd":
        levels = nf_levels(method, blocks.device)
        idx, mean, std = nf_meanstd_quantize_blocks(blocks, levels)
        out = nf_meanstd_dequantize_blocks(idx, mean, std, levels)
    elif method in ("bbint4", "bbint2"):
        out = affine_outlier_dequantize_blocks(
            affine_outlier_quantize_blocks(blocks, num_bits))
    elif method == "e8p":
        if num_bits != 2:
            raise ValueError("e8p is a fixed-rate 2-bit codebook")
        out = lattice.e8p_dequantize_blocks(
            *lattice.e8p_quantize_blocks(blocks))
    else:
        raise ValueError(f"unknown quantization method {method!r}")
    return unblockify(out, shape)
