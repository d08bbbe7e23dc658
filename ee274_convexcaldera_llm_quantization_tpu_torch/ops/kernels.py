"""W4A8 / W8A8 matmuls, packing and activation quantization in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.ops.kernels``.
The serving bytes are the reference's, unchanged: weights ``W`` (N, K) are
packed as uint8 in ``f = 8 / bits`` row-global planes, MSB first, so byte
``j`` of a row holds the offset-binary codes of ``k = j, j + K/f, ...,
j + (f-1) K/f`` (plane ``p`` at shift ``bits * (f - 1 - p)``).

The kernel wrappers (:func:`quantized_matmul_w4a8_stacked`,
:func:`int8_matmul`) launch a hand-written CUDA kernel for CUDA tensors and
run their plain PyTorch version, defined beside them, for CPU tensors only.
Integer dots in the plain versions run as float64 matmuls: every partial sum
of int8 x code products is an integer below 2**53, so they are exact in any
order, like the kernels' i32 sums.
"""

from __future__ import annotations

from typing import Optional

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import _build

# Candidate scale-group sizes, largest preferred (fewest scales).
_GROUP_CANDIDATES = (512, 256, 128, 64, 32, 16, 8)


def _pack_factor(num_bits: int) -> int:
    return 8 // num_bits


def container_bits(num_bits: int) -> int:
    """Device-resident container width for a quantization grid.

    2/4/8-bit grids pack natively; a 3-bit grid is served in the 4-bit
    container (its codes in [-3, 3] offset by the container's maxq = 7), as
    in the reference.
    """
    if num_bits in (2, 4, 8):
        return num_bits
    if num_bits == 3:
        return 4
    raise ValueError(f"unsupported serving grid {num_bits}-bit")


def resolve_group(num_bits: int, K: int, group_size: Optional[int]) -> int:
    """Pick the scale-group size: the largest candidate dividing ``K / f``;
    an explicit ``group_size`` is validated against the same constraint."""
    f = _pack_factor(num_bits)
    plane = K // f
    if group_size is None:
        for g in _GROUP_CANDIDATES:
            if g <= plane and plane % g == 0:
                return g
        return plane if plane > 0 else K
    if plane % group_size != 0:
        raise ValueError(
            f"group size {group_size} must divide K/f = {plane} "
            f"(K={K}, {num_bits}-bit)")
    return group_size


def pack_rowscale(W: torch.Tensor, num_bits: int):
    """Quantize with one symmetric absmax scale per output row.

    Returns ``(packed (N, K/f) uint8 in the row-global plane layout,
    row_scales (N, 1) f32)``; a 3-bit grid packs into the 4-bit container.
    """
    N, K = W.shape
    cb = container_bits(num_bits)
    f = _pack_factor(cb)
    maxq = 2 ** (num_bits - 1) - 1
    cmaxq = 2 ** (cb - 1) - 1
    Wf = W.float()
    absmax = Wf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    scales = absmax / maxq
    codes = torch.clamp(torch.round(Wf / scales), -maxq, maxq)
    u = (codes + cmaxq).to(torch.uint8)
    planes = u.reshape(N, f, K // f)
    packed = torch.zeros((N, K // f), dtype=torch.uint8, device=W.device)
    for p in range(f):
        packed |= planes[:, p, :] << (cb * (f - 1 - p))
    return packed, scales


def unpack_codes(packed: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Offset-binary codes (..., K) as uint8 from packed (..., K/f) bytes."""
    f = _pack_factor(num_bits)
    mask = (1 << num_bits) - 1
    planes = [(packed >> (num_bits * (f - 1 - p))) & mask for p in range(f)]
    return torch.cat(planes, dim=-1) if f > 1 else planes[0]


def quantize_activations_int8(x: torch.Tensor,
                              scale: Optional[torch.Tensor] = None):
    """Per-row symmetric int8 quantization of activations (M, K).

    ``scale`` ((M, 1) f32), when given, overrides the per-row absmax / 127.
    Returns ``(xq int8 (M, K), scale f32 (M, 1))``.
    """
    xf = x.float()
    if scale is None:
        absmax = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
        scale = absmax / 127.0
    xq = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return xq, scale


def quantize_int8_rowwise(W: torch.Tensor):
    """(..., N, K) -> (int8 codes, (..., N, 1) f32 row scales)."""
    Wf = W.float()
    absmax = Wf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    scales = absmax / 127.0
    codes = torch.clamp(torch.round(Wf / scales), -127, 127).to(torch.int8)
    return codes, scales


def _int_dot_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b.T`` of integer-valued tensors, returned as float64."""
    return a.double() @ b.double().T


def _rescale(acc: torch.Tensor, row_scales: torch.Tensor,
             sx: torch.Tensor) -> torch.Tensor:
    """``(acc * s_n) * sx_m`` in f32, the kernels' epilogue order."""
    return acc.float() * row_scales.reshape(1, -1).float() * sx


def _check_cuda_operands(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} "
                             f"vs {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


# ---------------------------------------------------------------------------
# W4A8 stacked matmul (replaces the TPU kernel #3)
# ---------------------------------------------------------------------------

def quantized_matmul_w4a8_stacked_plain(
        x: torch.Tensor, packed: torch.Tensor, row_scales: torch.Tensor,
        layer: int, num_bits: int,
        act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_matmul_w4a8_stacked`.

    ``y = sx_m * s_n * sum_k xq[m, k] * (u[n, k] - maxq)`` on layer
    ``layer``: for 2/4-bit the kernel's ``sum xq * u - maxq * rowsum(xq)``,
    for 8-bit its signed per-code path; both are this exact integer sum.
    """
    maxq = 2 ** (num_bits - 1) - 1
    xq, sx = quantize_activations_int8(x, act_scale)
    u = unpack_codes(packed[layer], num_bits)
    acc = _int_dot_t(xq, u) - maxq * xq.double().sum(dim=1, keepdim=True)
    return _rescale(acc, row_scales[layer], sx)


def quantized_matmul_w4a8_stacked(
        x: torch.Tensor, packed: torch.Tensor, row_scales: torch.Tensor,
        layer: int, num_bits: int,
        act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W4A8 matmul against layer ``layer`` of a stacked weight tensor.

    ``x`` (M, K) float, quantized to int8 per row (or with ``act_scale``);
    ``packed`` (L, N, K/f) uint8; ``row_scales`` (L, N, 1) f32. Returns
    (M, N) f32. CUDA tensors go through ``csrc/w4a8_stacked.cu``; CPU
    tensors through :func:`quantized_matmul_w4a8_stacked_plain`.
    """
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    f = _pack_factor(num_bits)
    M, K = x.shape
    Lk, N, P = packed.shape
    if P * f != K or row_scales.shape != (Lk, N, 1):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scales "
                         f"{tuple(row_scales.shape)} at {num_bits}-bit")
    if not 0 <= layer < Lk:
        raise IndexError(f"layer {layer} out of range for {Lk} layers")
    if x.device.type == "cpu":
        return quantized_matmul_w4a8_stacked_plain(
            x, packed, row_scales, layer, num_bits, act_scale)
    if num_bits not in (2, 4, 8) or K % (16 * f):
        raise ValueError(f"the CUDA kernel takes 2/4/8-bit codes with "
                         f"K % {16 * f} == 0, got {num_bits}-bit K={K}")
    xq, sx = quantize_activations_int8(x, act_scale)
    out = _launch_w4a8_stacked(xq, sx, packed, row_scales.float(), layer,
                               num_bits)
    quantized_matmul_w4a8_stacked.launches += 1
    return out


def _launch_w4a8_stacked(xq, sx, packed, scales, layer: int, num_bits: int):
    """Launch ``csrc/w4a8_stacked.cu`` on quantized activations."""
    M, K = xq.shape
    N = packed.shape[1]
    sx = sx.contiguous()
    _check_cuda_operands(xq, sx, packed, scales)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    err = _build.library("w4a8_stacked").w4a8_stacked_launch(
        xq.data_ptr(), sx.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        out.data_ptr(), M, N, K, num_bits, layer,
        _build.stream_ptr(xq.device))
    _build.check(err, "w4a8_stacked")
    return out


quantized_matmul_w4a8_stacked.launches = 0


def quantized_matmul_w4a8_xla(x, packed, row_scales, num_bits):
    """Unstacked W4A8 matmul (the reference's XLA twin), plain PyTorch."""
    return quantized_matmul_w4a8_stacked_plain(
        x, packed[None], row_scales[None], 0, num_bits)


# ---------------------------------------------------------------------------
# int8 matmul (replaces the TPU kernel #9; the port's lm_head)
# ---------------------------------------------------------------------------

def int8_matmul_plain(x: torch.Tensor, w_int8: torch.Tensor,
                      row_scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_matmul`."""
    xq, sx = quantize_activations_int8(x)
    return _rescale(_int_dot_t(xq, w_int8), row_scales, sx)


int8_matmul_xla = int8_matmul_plain


def int8_matmul(x: torch.Tensor, w_int8: torch.Tensor,
                row_scales: torch.Tensor) -> torch.Tensor:
    """``y = x @ (row_scales * w_int8).T`` with int8 activations per row.

    ``x`` (M, K) float; ``w_int8`` (N, K) int8; ``row_scales`` (N, 1) f32.
    CUDA tensors go through ``csrc/int8_matmul.cu``; CPU tensors through
    :func:`int8_matmul_plain`.
    """
    if w_int8.dtype != torch.int8:
        raise TypeError(f"w_int8 must be int8, got {w_int8.dtype}")
    M, K = x.shape
    N = w_int8.shape[0]
    if w_int8.shape != (N, K) or row_scales.shape != (N, 1):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w_int8.shape)}, scales "
                         f"{tuple(row_scales.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_int8, row_scales)
    if K % 16:
        raise ValueError(f"the CUDA kernel needs K % 16 == 0, got K={K}")
    xq, sx = quantize_activations_int8(x)
    out = _launch_int8_matmul(xq, sx, w_int8, row_scales.float())
    int8_matmul.launches += 1
    return out


def _launch_int8_matmul(xq, sx, w_int8, scales):
    """Launch ``csrc/int8_matmul.cu`` on quantized activations."""
    M, K = xq.shape
    N = w_int8.shape[0]
    sx = sx.contiguous()
    _check_cuda_operands(xq, sx, w_int8, scales)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    err = _build.library("int8_matmul").int8_matmul_launch(
        xq.data_ptr(), sx.data_ptr(), w_int8.data_ptr(), scales.data_ptr(),
        out.data_ptr(), M, N, K, _build.stream_ptr(xq.device))
    _build.check(err, "int8_matmul")
    return out


int8_matmul.launches = 0


def low_rank_matmul(x2: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                    L_scale: Optional[torch.Tensor] = None,
                    R_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x2 @ (L @ R).T`` as two thin dots, factors bf16 or int8 codes.

    As in the reference, ``x2`` and ``xr`` round to bf16 before each dot and
    the dots accumulate in f32 (operands upcast, exact for bf16 values);
    int8 factors dequantize as rank-1 column rescales. ``L`` (N, r), ``R``
    (r, K), scales (N, 1) / (r, 1).
    """
    def bf16(t):
        return t.to(torch.bfloat16).float()

    xr = bf16(x2) @ bf16(R).T
    if R_scale is not None:
        xr = xr * R_scale[:, 0][None, :]
    ylr = bf16(xr) @ bf16(L).T
    if L_scale is not None:
        ylr = ylr * L_scale[:, 0][None, :]
    return ylr
