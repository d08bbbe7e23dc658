"""W4A8 / W8A8 matmuls, packing and activation quantization in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.ops.kernels``.
The serving bytes are the reference's, unchanged: weights ``W`` (N, K) are
packed as uint8 in ``f = 8 / bits`` row-global planes, MSB first, so byte
``j`` of a row holds the offset-binary codes of ``k = j, j + K/f, ...,
j + (f-1) K/f`` (plane ``p`` at shift ``bits * (f - 1 - p)``).

The kernel wrappers (:func:`quantized_matmul`, :func:`quantized_matmul_w4a8`,
:func:`quantized_matmul_w4a8_stacked` and its persistent launch
:func:`quantized_matmul_w4a8_stacked_persistent`, :func:`int8_matmul`,
:func:`bf16_matmul_stacked` and the
low-rank-fused :func:`quantized_matmul_w4a8_l_stacked`,
:func:`quantized_matmul_w4a8_lr_stacked`,
:func:`quantized_matmul_w4a8_mlp_stacked`) launch a
hand-written CUDA kernel for CUDA tensors and run their plain PyTorch
version, defined beside them, for CPU tensors only. Integer dots in the
plain versions run as float64 matmuls: every partial sum of int8 x code
products is an integer below 2**53, so they are exact in any order, like the
kernels' i32 sums. The grouped (bf16) plain version dequantizes to bf16 and
multiplies in f32: each bf16 x bf16 product is exact in f32, so it differs
from the kernel only in the order of its f32 sums.

:func:`fwht`, :func:`hadamard_sandwich` and :func:`hadamard_unsandwich`
(model surgery's Hadamard rotations) are plain torch butterflies, as in the
reference, where they are no Pallas kernel either.
"""

from __future__ import annotations

import ctypes
import functools
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


def resolve_block_n(block_n, num_bits: int = 4) -> int:
    """The reference's default output-block rows of its TPU kernels (512,
    or 256 for the 2-bit container), kept for parity; the CUDA kernels
    choose their own tiling."""
    if block_n is not None:
        return block_n
    return 256 if num_bits == 2 else 512


def _pack_planes(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Offset-binary codes (N, K) uint8 -> (N, K/f) row-global planes."""
    N, K = u.shape
    f = _pack_factor(bits)
    planes = u.reshape(N, f, K // f)
    packed = torch.zeros((N, K // f), dtype=torch.uint8, device=u.device)
    for p in range(f):
        packed |= planes[:, p, :] << (bits * (f - 1 - p))
    return packed


def pack_rowscale(W: torch.Tensor, num_bits: int):
    """Quantize with one symmetric absmax scale per output row.

    Returns ``(packed (N, K/f) uint8 in the row-global plane layout,
    row_scales (N, 1) f32)``; a 3-bit grid packs into the 4-bit container.
    """
    cb = container_bits(num_bits)
    maxq = 2 ** (num_bits - 1) - 1
    cmaxq = 2 ** (cb - 1) - 1
    Wf = W.float()
    absmax = Wf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    scales = absmax / maxq
    codes = torch.clamp(torch.round(Wf / scales), -maxq, maxq)
    return _pack_planes((codes + cmaxq).to(torch.uint8), cb), scales


def pack_for_serving(W: torch.Tensor, num_bits: int,
                     group_size: Optional[int] = None):
    """Quantize ``W`` (N, K) to plane-packed codes with one symmetric absmax
    scale per (row, group of ``G`` consecutive k).

    Returns ``(packed (N, K/f) uint8, scales (N, K/G) f32)``; ``G`` as
    :func:`resolve_group` picks or validates it.
    """
    N, K = W.shape
    G = resolve_group(num_bits, K, group_size)
    maxq = 2 ** (num_bits - 1) - 1
    Wg = W.float().reshape(N, K // G, G)
    absmax = Wg.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    scales = (absmax / maxq).reshape(N, K // G)
    codes = torch.clamp(torch.round(Wg / absmax * maxq), -maxq, maxq)
    u = (codes + maxq).to(torch.uint8).reshape(N, K)
    return _pack_planes(u, num_bits), scales


def dequant_serving_xla(packed: torch.Tensor, scales: torch.Tensor,
                        num_bits: int,
                        group_size: Optional[int] = None) -> torch.Tensor:
    """The dense bf16 weights ``bf16((u - maxq) * s[n, k // G])`` of packed
    (..., N, K/f) codes and (..., N, K/G) scales (the f32 product rounded
    once to bf16, as the reference's twin does)."""
    K = packed.shape[-1] * _pack_factor(num_bits)
    G = resolve_group(num_bits, K, group_size)
    maxq = 2 ** (num_bits - 1) - 1
    q = unpack_codes(packed, num_bits).float() - maxq
    return (q * scales.float().repeat_interleave(G, dim=-1)).to(
        torch.bfloat16)


def unpack_codes(packed: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Offset-binary codes (..., K) as uint8 from packed (..., K/f) bytes."""
    f = _pack_factor(num_bits)
    mask = (1 << num_bits) - 1
    # torch.bitwise_right_shift, not ``>>``: a DTensor (parallel.mesh)
    # returns its input unchanged from ``>>`` with a Python int
    planes = [torch.bitwise_right_shift(packed, num_bits * (f - 1 - p)) & mask
              for p in range(f)]
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
# Grouped-scale bf16 matmul (replaces the TPU kernel #1)
# ---------------------------------------------------------------------------

def quantized_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                           scales: torch.Tensor, num_bits: int,
                           group_size: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_matmul`: the bf16 weights
    of :func:`dequant_serving_xla` times ``bf16(x)``, both upcast to f32
    (exact) and summed in f32."""
    W = dequant_serving_xla(packed, scales, num_bits, group_size)
    return x.to(torch.bfloat16).float() @ W.float().T


# the reference's XLA twin is the same function
quantized_matmul_xla = quantized_matmul_plain


def quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, num_bits: int,
                     group_size: Optional[int] = None) -> torch.Tensor:
    """``y = bf16(x) @ bf16((u - maxq) * s[n, k // G]).T`` in f32.

    ``x`` (M, K) float; ``packed`` (N, K/f) uint8 row-global planes;
    ``scales`` (N, K/G) f32 with ``G`` from :func:`resolve_group`. Returns
    (M, N) f32. CUDA tensors go through ``csrc/grouped_matmul.cu`` (TMA and
    bf16 ``wgmma``, dequantizing in front of the tensor cores, on the plan of
    :func:`_grouped_plan`); CPU tensors through
    :func:`quantized_matmul_plain`.
    """
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    f = _pack_factor(num_bits)
    M, K = x.shape
    N, P = packed.shape
    G = resolve_group(num_bits, K, group_size)
    if P * f != K or scales.shape != (N, K // G):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scales "
                         f"{tuple(scales.shape)} at {num_bits}-bit, G={G}")
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, packed, scales, num_bits, G)
    if num_bits not in (2, 4, 8) or P % 32 or G % 16:
        raise ValueError(f"the CUDA kernel takes 2/4/8-bit codes with "
                         f"K/f % 32 == 0 and G % 16 == 0 (TMA rows of packed "
                         f"bytes, one scale per 16 bytes), got "
                         f"{num_bits}-bit K={K} G={G}")
    out = _launch_grouped(x.to(torch.bfloat16).contiguous(), packed,
                          scales.float().contiguous(), num_bits, G)
    quantized_matmul.launches += 1
    return out


# The CUDA kernel's tiles (csrc/grouped_matmul.cu): steps of 64 packed bytes
# of a weight row (64 k of each plane); at M <= 16, 64 weight rows and 8 or 16
# activation rows a CTA (several CTAs an SM); above, 128 weight rows and 64
# or 128 activation rows (one CTA an SM). K is split as _split_k says.
_GROUPED_BK = 64
_GROUPED_SPLIT_MAX_M = 16
# M <= 16 splits K until the grid holds about three CTAs per SM: at M 8 on an
# H100 80GB HBM3 (700 W), 4096 x 4096 took 0.0113 ms at 512 CTAs and 0.0207
# at 64; 11008 x 4096 0.0209 at 516 and 0.0290 at 172; 4096 x 11008 0.0241
# at 512 and 0.0656 at 64 (scripts/torch_grouped_times.py --sweep)
_GROUPED_SPLITK_WAVES = 3


# A split of a split-K launch walks at least this many steps unless K has fewer
_MIN_SPLIT_STEPS = 4


def _split_k(tiles: int, rows: int, cols: int, k_steps: int, want: int,
             split_steps: Optional[int] = None) -> dict:
    """The K split of a split-K launch (``csrc/grouped_matmul.cu``, the xr
    kernel of ``csrc/w4a8_lowrank.cu``) of ``tiles`` output tiles of
    ``rows`` x ``cols``, each walking ``k_steps`` steps: ``splits`` CTAs a
    tile of ``split_steps`` steps each, the last possibly shorter; ``want``
    splits, but no split except the last walks fewer than
    ``_MIN_SPLIT_STEPS`` steps; ``split_steps`` overrides the count (for
    tuning). ``workspace`` f32 hold the partial tiles when ``splits`` > 1,
    which the last CTA of a tile sums in split order
    (``hopper_gemm.cuh::splitk_sum``)."""
    if split_steps is None:
        splits = max(1, min(want, k_steps // _MIN_SPLIT_STEPS))
        split_steps = -(-k_steps // splits)
    split_steps = max(1, min(split_steps, k_steps))
    splits = -(-k_steps // split_steps)
    return dict(tiles=tiles, splits=splits, split_steps=split_steps,
                workspace=splits * tiles * rows * cols if splits > 1 else 0)


def _grouped_plan(M: int, N: int, K: int, bits: int, sms: int = 132,
                  split_steps: Optional[int] = None) -> dict:
    """How ``csrc/grouped_matmul.cu`` runs ``(M, K) @ W.T`` with ``W`` (N, K)
    packed at ``bits``: ``path`` "splitk" at M <= 16 (64 weight rows and the
    M activation rows as wgmma's ``cols`` = 8 or 16 columns a CTA) or
    "tiled" above (128 weight rows and ``cols`` = 64 or 128 activation rows
    a CTA); either walks the ``K / f`` packed bytes of a row in ``splits``
    CTAs of ``split_steps`` 64-byte steps each, the last possibly shorter,
    and ``workspace`` f32 hold their partial tiles (one arrival counter for
    each of the ``tiles``) when ``splits`` > 1. ``grid`` is the launch's (N
    tiles, M tiles, splits). The split count is the least that brings the
    grid to three CTAs per SM (splitk: several fit an SM) or the most that
    keeps it within one CTA per SM (tiled), but no split except the last
    walks fewer than 4 steps. ``split_steps`` overrides the steps per split
    (for tuning)."""
    k_steps = -(-(K // (8 // bits)) // _GROUPED_BK)
    if M <= _GROUPED_SPLIT_MAX_M:
        path, rows, cols = "splitk", 64, 8 if M <= 8 else 16
    else:
        path, rows, cols = "tiled", 128, 64 if M <= 64 else 128
    grid_nm = (-(-N // rows), -(-M // cols))
    tiles = grid_nm[0] * grid_nm[1]
    want = (-(-_GROUPED_SPLITK_WAVES * sms // tiles) if path == "splitk"
            else sms // tiles)
    plan = _split_k(tiles, rows, cols, k_steps, want, split_steps)
    return dict(path=path, rows=rows, cols=cols,
                grid=grid_nm + (plan["splits"],), **plan)


# Zeroed split-K arrival counters per (device, stream): a launch's last CTA
# of each tile sets its counter back to 0, so launches in stream order share
# them, and launches on two streams never do. Counters made while a stream
# is captured belong to that capture's graph (the zeroing is a node of it),
# so each capture gets its own.
_SPLIT_COUNTERS: dict = {}


def _split_counters(device: torch.device, tiles: int) -> torch.Tensor:
    stream = _build.stream_ptr(device)
    capture = ctypes.c_ulonglong(0)
    _build.check(_build.library("grouped_matmul").grouped_capture_id(
        stream, ctypes.byref(capture)), "grouped_capture_id")
    key = (device.index, stream)
    held = _SPLIT_COUNTERS.get(key)
    if held is None or held[0] != capture.value or held[1].numel() < tiles:
        held = (capture.value, torch.zeros(max(tiles, 1024),
                                           dtype=torch.int32, device=device))
        _SPLIT_COUNTERS[key] = held
    return held[1]


def _launch_grouped(xb, packed, scales, num_bits: int, G: int,
                    split_steps: Optional[int] = None):
    """Launch ``grouped_matmul_launch`` of ``csrc/grouped_matmul.cu`` on bf16
    activations, on the plan of :func:`_grouped_plan` (a split-K workspace
    from ``torch.empty``, counters from :func:`_split_counters`)."""
    M, K = xb.shape
    N = packed.shape[0]
    _check_cuda_operands(xb, packed, scales)
    # TMA reads x and the packed bytes from 16-byte aligned bases: a layer of
    # a stacked slab is read in place, a view off that alignment is copied
    xb, packed = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (xb, packed))
    index = xb.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = _grouped_plan(M, N, K, num_bits, _sm_count(index), split_steps)
    out = torch.empty((M, N), dtype=torch.float32, device=xb.device)
    ws = counters = None
    if plan["splits"] > 1:
        ws = torch.empty(plan["workspace"], dtype=torch.float32,
                         device=xb.device)
        counters = _split_counters(xb.device, plan["tiles"])
    err = _build.library("grouped_matmul").grouped_matmul_launch(
        xb.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), M, N, K,
        num_bits, G, 0 if plan["path"] == "splitk" else 1, plan["cols"],
        plan["split_steps"], plan["splits"], _build.stream_ptr(xb.device))
    _build.check(err, "grouped_matmul")
    return out


quantized_matmul.launches = 0


def fused_qlr_matmul(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                     num_bits: int, group_size: Optional[int] = None,
                     global_scale=1.0) -> torch.Tensor:
    """``y = x @ (gs * (Q + L @ R)).T`` with Q grouped and bit-packed: one
    :func:`quantized_matmul` plus the two bf16 factor dots of
    :func:`low_rank_matmul`. ``L`` (N, r), ``R`` (r, K) bf16."""
    yq = quantized_matmul(x, packed, scales, num_bits, group_size)
    return (yq + low_rank_matmul(x, L, R)) * global_scale


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


def _check_w4a8_stacked(x, packed, row_scales, layer: int,
                        num_bits: int) -> None:
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    f = _pack_factor(num_bits)
    K = x.shape[1]
    Lk, N, P = packed.shape
    if P * f != K or row_scales.shape != (Lk, N, 1):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scales "
                         f"{tuple(row_scales.shape)} at {num_bits}-bit")
    if not 0 <= layer < Lk:
        raise IndexError(f"layer {layer} out of range for {Lk} layers")
    if x.device.type != "cpu" and (num_bits not in (2, 4, 8) or K % (16 * f)):
        raise ValueError(f"the CUDA kernel takes 2/4/8-bit codes with "
                         f"K % {16 * f} == 0, got {num_bits}-bit K={K}")


def quantized_matmul_w4a8_stacked(
        x: torch.Tensor, packed: torch.Tensor, row_scales: torch.Tensor,
        layer: int, num_bits: int,
        act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W4A8 matmul against layer ``layer`` of a stacked weight tensor.

    ``x`` (M, K) float, quantized to int8 per row (or with ``act_scale``);
    ``packed`` (L, N, K/f) uint8; ``row_scales`` (L, N, 1) f32. Returns
    (M, N) f32. CUDA tensors go through ``csrc/w4a8_stacked.cu`` on the
    plan of :func:`_w4a8_plan` (the ``rowdot`` kernel at decode M, the int8
    ``wgmma`` tile kernel above it; the same bits); CPU tensors through
    :func:`quantized_matmul_w4a8_stacked_plain`.
    """
    _check_w4a8_stacked(x, packed, row_scales, layer, num_bits)
    if x.device.type == "cpu":
        return quantized_matmul_w4a8_stacked_plain(
            x, packed, row_scales, layer, num_bits, act_scale)
    xq, sx = quantize_activations_int8(x, act_scale)
    out = _launch_w4a8_stacked(xq, sx, packed, row_scales.float(), layer,
                               num_bits)
    quantized_matmul_w4a8_stacked.launches += 1
    return out


# The CUDA kernel's two designs (csrc/w4a8_stacked.cu): at M <= 8 (decode)
# the rowdot kernel (rowdot.cuh: one warp walks weight rows with __dp4a, 8- or
# 32-row M tiles, every weight byte read once per M tile); above, the tile
# kernel (TMA, an unpacker warpgroup, int8 wgmma m64n144k32, persistent
# CTAs): tiles of 128 weight rows and 64 or 128 activation rows, 128 packed
# bytes of a weight row a step. The tile kernel's i32 sums hold while
# K <= 2^31 / (127 * 255).
# On an H100 80GB HBM3 (700 W, scripts/torch_w4a8_times.py --sweep) the tile
# kernel beat rowdot at every M from 9 (qkv at M 9: 0.0188 against 0.1614
# ms; at M 8 too, 0.0184 against 0.0323, but decode keeps its kernel), and
# 64-row tiles beat 128 exactly where they were no more than the larger of
# the SM count and the 128-row tiles (o at M 256: 128 tiles, 0.0165 against
# 0.0207 ms; qkv at M 96: 192, 0.0305 against 0.0217).
_W4A8_ROWDOT_MAX_M = 8
_W4A8_TILE_BK = 128
_W4A8_TILE_BN = 128
_W4A8_TILE_MAX_K = (2 ** 31 - 1) // (127 * 255)


def _w4a8_plan(M: int, N: int, K: int, bits: int, sms: int = 132,
               path: Optional[str] = None,
               rows: Optional[int] = None) -> dict:
    """How ``csrc/w4a8_stacked.cu`` runs ``(M, K) @ W.T`` with ``W`` (N, K)
    packed at ``bits``: ``path`` "rowdot" at M <= 8 (``rows`` = 8 or 32
    activation rows and ``cols`` = 32 or 8 weight rows a CTA) or "tile"
    above (``tiles`` = (M tiles, N tiles) of ``rows`` = 64 or 128
    activation rows and ``cols`` = 128 weight rows, each walking the ``K /
    f`` packed bytes of a row in ``steps`` steps of 128 that feed ``f``
    planes; ``straddle``: the last step's boxes reach past the end of a
    plane, where TMA fills zeros). The tile takes 64 rows while its count
    is no larger than the larger of ``sms`` and the 128-row count, else
    128. ``grid`` is the launch's: for the tile path one persistent CTA a
    tile, at most one an SM. ``path`` and ``rows`` override the choice (for
    tuning and for comparing the two designs). Raises where the tile
    kernel's i32 sums could overflow (K over 66311)."""
    f = 8 // bits
    P = K // f
    if path is None:
        path = "rowdot" if M <= _W4A8_ROWDOT_MAX_M else "tile"
    if path == "rowdot":
        rows = 8 if M <= 8 else 32
        cols = 32 if rows == 8 else 8
        return dict(path=path, rows=rows, cols=cols,
                    grid=(-(-N // cols), -(-M // rows)))
    if path != "tile":
        raise ValueError(f"unknown W4A8 path {path!r}")
    if K > _W4A8_TILE_MAX_K:
        raise ValueError(f"the W4A8 tile kernel's i32 sums hold K <= "
                         f"{_W4A8_TILE_MAX_K} (127 x 255 per product), got "
                         f"K={K}")
    n_tiles = -(-N // _W4A8_TILE_BN)
    if rows is None:
        tiles_64, tiles_128 = -(-M // 64) * n_tiles, -(-M // 128) * n_tiles
        rows = 64 if tiles_64 <= max(sms, tiles_128) else 128
    if rows not in (64, 128):
        raise ValueError(f"the W4A8 tile kernel takes 64 or 128 activation "
                         f"rows a CTA, got {rows}")
    steps = -(-P // _W4A8_TILE_BK)
    tiles = (-(-M // rows), n_tiles)
    return dict(path=path, rows=rows, cols=_W4A8_TILE_BN, steps=steps,
                straddle=P % _W4A8_TILE_BK != 0, tiles=tiles,
                grid=(min(tiles[0] * tiles[1], sms),))


def _launch_w4a8_stacked(xq, sx, packed, scales, layer: Optional[int],
                         num_bits: int, persistent: bool = False,
                         path: Optional[str] = None,
                         rows: Optional[int] = None,
                         ctas: Optional[int] = None):
    """Launch ``csrc/w4a8_stacked.cu`` on quantized activations against
    layer ``layer`` of a stacked (L, N, K/f) tensor, or a flat (N, K/f)
    tensor when ``layer`` is None (the flat entry point), on the plan of
    :func:`_w4a8_plan` (``path`` and ``rows`` passed on to it); where the
    plan is ``rowdot`` and ``persistent`` is set, the weight stream of
    ``w4a8_stream.cuh`` on the plan of :func:`_w4a8_stream_plan` (``ctas``
    passed on to it); the tile path's CTAs are persistent already. A failed
    launch raises: no design stands in for another."""
    M, K = xq.shape
    N = packed.shape[-2]
    sx = sx.contiguous()
    _check_cuda_operands(xq, sx, packed, scales)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    lib = _build.library("w4a8_stacked")
    stream = _build.stream_ptr(xq.device)
    index = xq.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = _w4a8_plan(M, N, K, num_bits, _sm_count(index), path, rows)
    if plan["path"] == "tile" or (persistent and layer is not None):
        # TMA reads x and the layer's bytes from 16-byte aligned bases (the
        # tile path and the stream alike): a layer of a stacked slab is read
        # in place, a view off that alignment is copied
        xq, packed = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (xq, packed))
    if plan["path"] == "tile":
        err = lib.w4a8_tile_launch(
            xq.data_ptr(), sx.data_ptr(), packed.data_ptr(),
            scales.data_ptr(), out.data_ptr(), M, N, K, num_bits,
            0 if layer is None else layer, plan["rows"], plan["grid"][0],
            stream)
        _build.check(err, "w4a8_tile")
        return out
    args = (xq.data_ptr(), sx.data_ptr(), packed.data_ptr(),
            scales.data_ptr(), out.data_ptr())
    if layer is None:
        err = lib.w4a8_launch(*args, M, N, K, num_bits, stream)
    elif persistent:
        sp = _w4a8_stream_plan(M, N, K, num_bits, _sm_count(index), ctas)
        cnt = _split_counters(xq.device, sp["counters"])
        err = lib.w4a8_stacked_persistent_launch(
            *args, cnt.data_ptr(), M, N, K, num_bits, layer, sp["ctas"],
            sp["warps"], stream)
    else:
        err = lib.w4a8_stacked_launch(*args, M, N, K, num_bits, layer,
                                      stream)
    _build.check(err, "w4a8_stacked")
    return out


quantized_matmul_w4a8_stacked.launches = 0


# ---------------------------------------------------------------------------
# W4A8 stacked matmul, persistent launch (replaces the TPU kernel #4)
# ---------------------------------------------------------------------------

# The persistent launch at M <= 8 (csrc/w4a8_stream.cuh): slabs of 32 weight
# rows x 128 packed bytes (group-major: every chunk of a group of 32 rows,
# then the next group), cut into equal contiguous ranges, one a warp, over
# CTAs of 8 warps, one CTA an SM; a split group's partials are added into
# its 256 i32 sums (8 a lane), zero before and after a launch.
_STREAM_KC = 128
_STREAM_ROWS = 32
_STREAM_WARPS = 8
_STREAM_SUMS = 8 * 32
# the stream's i32 sums hold while K * 127 * 128 < 2^31
_STREAM_MAX_K = (2 ** 31 - 1) // (127 * 128)


@functools.lru_cache(maxsize=None)
def _w4a8_stream_plan(M: int, N: int, K: int, bits: int, sms: int = 132,
                      ctas: Optional[int] = None) -> dict:
    """How ``csrc/w4a8_stream.cuh`` runs the persistent launch at 1 <= M <=
    8: each row of ``P`` packed bytes in ``nk`` chunks of 128, ``groups``
    groups of 32 rows (the last ragged), ``slabs`` = groups x nk slabs of
    (group, chunk), group-major, cut over ``ctas`` CTAs of ``warps`` warps
    (``W`` warps in all; warp ``w`` takes slabs ``[S w / W, S (w + 1) /
    W)``: between ``per_warp`` slabs). One CTA an SM, of 8 warps or as many
    as the layer has slabs an SM, and fewer CTAs where it has fewer slabs
    than SMs, so that every warp has a slab (``S >= W``); ``ctas`` takes the
    place of the SM count (for tests). ``counters``: the zeroed int32s of
    the split (a counter a group, then each group's 256 sums);
    ``contributors``: the most warps that share a group. Raises where M is
    out of range, where the i32 sums could overflow (K over 132104) or
    where the kernel's 32-bit range math would not hold (S x W >=
    2^32)."""
    if not 1 <= M <= 8:
        raise ValueError(f"the W4A8 stream kernel takes 1 to 8 activation "
                         f"rows, got M={M}")
    if K > _STREAM_MAX_K:
        raise ValueError(f"the W4A8 stream kernel's i32 sums hold K <= "
                         f"{_STREAM_MAX_K} (127 x 128 per product), got "
                         f"K={K}")
    P = K // (8 // bits)
    nk, groups = -(-P // _STREAM_KC), -(-N // _STREAM_ROWS)
    S = groups * nk
    ctas = sms if ctas is None else ctas
    warps = max(1, min(_STREAM_WARPS, S // ctas))
    ctas = min(ctas, S // warps)
    W = ctas * warps
    if S * W >= 2 ** 32:
        raise ValueError(f"the W4A8 stream kernel's range math holds S x W "
                         f"< 2^32, got {S} slabs x {W} warps")
    contributors = max(
        _fused_owner((g + 1) * nk - 1, S, W) - _fused_owner(g * nk, S, W) + 1
        for g in range(groups))
    return dict(P=P, nk=nk, groups=groups, slabs=S, warps=warps, ctas=ctas,
                W=W, per_warp=(S // W, -(-S // W)),
                counters=groups * (1 + _STREAM_SUMS),
                contributors=contributors)


# the persistent kernel's function is kernel 1's, bit for bit
quantized_matmul_w4a8_stacked_persistent_plain = \
    quantized_matmul_w4a8_stacked_plain


def quantized_matmul_w4a8_stacked_persistent(
        x: torch.Tensor, packed: torch.Tensor, row_scales: torch.Tensor,
        layer: int, num_bits: int,
        act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`quantized_matmul_w4a8_stacked` on persistent CTAs. At M <= 8
    (decode) the weight stream of ``csrc/w4a8_stream.cuh``
    (``w4a8_stacked_persistent_launch`` of ``csrc/w4a8_stacked.cu``, on the
    plan of :func:`_w4a8_stream_plan`): one CTA of 8 warps an SM, each warp
    streaming its equal share of the layer's (32-row group, 128-byte chunk)
    slabs and their activations through a ring of TMA boxes into int8
    ``mma.sync``, split groups summed exactly by their last warp. Above M 8
    the grid launch's int8 ``wgmma`` tile path (:func:`_w4a8_plan`), whose
    CTAs are persistent, one an SM. Same arguments; the output equals the
    grid kernel's bit for bit. CPU tensors go through its plain version.
    """
    _check_w4a8_stacked(x, packed, row_scales, layer, num_bits)
    if x.device.type == "cpu":
        return quantized_matmul_w4a8_stacked_persistent_plain(
            x, packed, row_scales, layer, num_bits, act_scale)
    xq, sx = quantize_activations_int8(x, act_scale)
    out = _launch_w4a8_stacked(xq, sx, packed, row_scales.float(), layer,
                               num_bits, persistent=True)
    quantized_matmul_w4a8_stacked_persistent.launches += 1
    return out


quantized_matmul_w4a8_stacked_persistent.launches = 0


# ---------------------------------------------------------------------------
# W4A8 stacked matmuls with the low-rank factors fused in (replace the TPU
# kernels #5, #6 and #7): csrc/w4a8_lowrank.cu
# ---------------------------------------------------------------------------

def _require(cond: bool, what: str) -> None:
    """The reference's ``assert`` contracts, kept as AssertionErrors that
    ``python -O`` does not strip (the kernels read through raw pointers)."""
    if not cond:
        raise AssertionError(what)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and upcast to f32 (exact), the reference's
    bf16 dot operand."""
    return t.to(torch.bfloat16).float()


def lr_stacked_supported(splits, ranks, block_n: Optional[int] = None,
                         num_bits: int = 4) -> bool:
    """Whether the fused-factor stacked kernels take this fusion group: one
    rank for all projections, rank windows on 128-lane boundaries (or a
    single projection), and a common output block of at least 128 rows
    after the reference's halving chain. The verdict decides whether
    ``quantize_factors_int8_fused`` builds ``L_cat``, so it is the
    reference's, block chain included, although the CUDA kernels take any
    split."""
    if len(set(ranks)) != 1:
        return False
    if len(splits) > 1 and ranks[0] % 128 != 0:
        return False
    block_n = min(resolve_block_n(block_n, num_bits), min(splits))
    while any(n % block_n for n in splits):
        block_n //= 2
    return block_n >= 128


def mlp_stacked_supported(im: int, h: int, rank: int, num_bits: int) -> bool:
    """Whether the whole-MLP kernel takes this MLP (the reference's gate:
    rank on 128-lane boundaries, 128-divisible blocks of at most 256)."""
    if rank % 128:
        return False
    bn1 = min(256, im)
    bn2 = min(256, h)
    return (im % bn1 == 0 and h % bn2 == 0 and bn1 >= 128 and bn2 >= 128
            and (8 // container_bits(num_bits)) >= 1)


def thin_xr(x: torch.Tensor, R_l: torch.Tensor,
            R_scale_l: torch.Tensor) -> torch.Tensor:
    """``xr = (bf16(x) @ bf16(R_l).T) * R_scale_l``: the thin contraction
    with one layer's int8 ``R`` codes (r, K) and their (r, 1) scales, f32
    sums of exact products."""
    return (_bf16(x) @ R_l.float().T) * R_scale_l[:, 0].float()[None, :]


def _l_epilogue(xr, L_l, Ls_l, rank: int, splits) -> torch.Tensor:
    """``ylr * Ls``: per projection ``i``, ``bf16(xr window i) @ L_i.T``
    (int8 codes, exact in bf16) times the row scales; a single projection
    takes the whole ``xr``."""
    outs, off = [], 0
    for i, n in enumerate(splits):
        xw = xr if len(splits) == 1 else xr[:, i * rank:(i + 1) * rank]
        ylr = _bf16(xw) @ L_l[off:off + n].float().T
        outs.append(ylr * Ls_l[off:off + n, 0].float()[None, :])
        off += n
    return torch.cat(outs, dim=1)


def _check_l_args(x, packed, row_scales, layer: int, L_cat, L_scale_cat,
                  num_bits: int, splits) -> None:
    f = _pack_factor(num_bits)
    M, K = x.shape
    Lk, N, P = packed.shape
    _require(P * f == K, f"packed {tuple(packed.shape)} against K={K} at "
             f"{num_bits}-bit")
    _require(packed.dtype == torch.uint8, f"packed is {packed.dtype}")
    _require(sum(splits) == N and L_cat.shape[1] == N,
             f"splits {tuple(splits)} and L_cat {tuple(L_cat.shape)} "
             f"against N={N}")
    if (row_scales.shape != (Lk, N, 1) or L_cat.shape[0] != Lk
            or L_scale_cat.shape != (Lk, N, 1)):
        raise ValueError(f"shape mismatch: packed {tuple(packed.shape)}, "
                         f"scales {tuple(row_scales.shape)}, L_cat "
                         f"{tuple(L_cat.shape)}, L scales "
                         f"{tuple(L_scale_cat.shape)}")
    if not 0 <= layer < Lk:
        raise IndexError(f"layer {layer} out of range for {Lk} layers")


def quantized_matmul_w4a8_l_stacked_plain(
        x: torch.Tensor, packed: torch.Tensor, row_scales: torch.Tensor,
        layer: int, xr: torch.Tensor, L_cat: torch.Tensor,
        L_scale_cat: torch.Tensor, num_bits: int, rank: int, splits,
        act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_matmul_w4a8_l_stacked`:
    ``(acc * s_n) * sx_m + (bf16(xr window) @ bf16(L).T) * Ls_n``, the
    integer part exact as in
    :func:`quantized_matmul_w4a8_stacked_plain`."""
    _check_l_args(x, packed, row_scales, layer, L_cat, L_scale_cat,
                  num_bits, splits)
    _require(tuple(xr.shape) == (x.shape[0], len(splits) * rank),
             f"xr {tuple(xr.shape)} against splits {tuple(splits)}, rank "
             f"{rank}")
    xq, sx = quantize_activations_int8(x, act_scale)
    return _l_from_codes(xq, sx, packed, row_scales, layer, xr, L_cat,
                         L_scale_cat, num_bits, rank, splits)


def _l_from_codes(xq, sx, packed, row_scales, layer: int, xr, L_cat,
                  L_scale_cat, num_bits: int, rank: int, splits):
    """The l kernel's plain arithmetic on int8 activation codes ``xq`` and
    their row scales ``sx``."""
    maxq = 2 ** (num_bits - 1) - 1
    u = unpack_codes(packed[layer], num_bits)
    acc = _int_dot_t(xq, u) - maxq * xq.double().sum(dim=1, keepdim=True)
    return (_rescale(acc, row_scales[layer], sx)
            + _l_epilogue(xr.float(), L_cat[layer], L_scale_cat[layer], rank,
                          splits))


def _split_bounds(splits, N: int):
    """The ends of projections 0..2 for the kernels (N where unused)."""
    ends = [sum(splits[:i + 1]) for i in range(len(splits) - 1)]
    return ends + [N] * (3 - len(ends))


def _check_lowrank_cuda(num_bits: int, K: int, splits) -> None:
    f = _pack_factor(num_bits)
    if num_bits not in (2, 4, 8) or K % (16 * f) or len(splits) > 4:
        raise ValueError(f"the CUDA kernel takes 2/4/8-bit codes with "
                         f"K % {16 * f} == 0 and at most 4 fused "
                         f"projections, got {num_bits}-bit K={K}, "
                         f"{len(splits)} projections")


def quantized_matmul_w4a8_l_stacked(
        x: torch.Tensor, packed: torch.Tensor, row_scales: torch.Tensor,
        layer: int, xr: torch.Tensor, L_cat: torch.Tensor,
        L_scale_cat: torch.Tensor, num_bits: int, rank: int, splits,
        act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W4A8 matmul plus the L half of the low-rank factors, against layer
    ``layer``, for a fusion group of ``len(splits)`` same-input projections.

    ``x`` (M, K) float (int8 per row, or with ``act_scale``); ``packed``
    (L, N, K/f) uint8 and ``row_scales`` (L, N, 1) f32 with N = sum(splits);
    ``xr`` (M, n_proj * rank) f32, the caller's ``(bf16(x) @ bf16(R[l]).T) *
    R_scale[l]``; ``L_cat`` (L, N, rank) int8 N-concatenated factor codes,
    ``L_scale_cat`` (L, N, 1) f32. Returns (M, N) f32, global scales and
    biases left to the caller. CUDA tensors go through
    ``csrc/w4a8_lowrank.cu`` on the plan of :func:`_w4a8_l_plan` (the
    ``rowdot``-based ``l_kernel`` at decode M, the int8 ``wgmma`` tile
    kernel with its L epilogue above it); CPU tensors through
    :func:`quantized_matmul_w4a8_l_stacked_plain`.
    """
    if x.device.type == "cpu":
        return quantized_matmul_w4a8_l_stacked_plain(
            x, packed, row_scales, layer, xr, L_cat, L_scale_cat, num_bits,
            rank, splits, act_scale)
    _check_l_args(x, packed, row_scales, layer, L_cat, L_scale_cat,
                  num_bits, splits)
    _require(tuple(xr.shape) == (x.shape[0], len(splits) * rank),
             f"xr {tuple(xr.shape)} against splits {tuple(splits)}, rank "
             f"{rank}")
    _check_lowrank_cuda(num_bits, x.shape[1], splits)
    xq, sx = quantize_activations_int8(x, act_scale)
    out = _launch_l(xq, sx, packed, row_scales.float(), layer,
                    xr.float().contiguous(), L_cat,
                    L_scale_cat.float().contiguous(), num_bits, rank, splits)
    quantized_matmul_w4a8_l_stacked.launches += 1
    return out


# The L-fused kernel's two designs (csrc/w4a8_lowrank.cu), on _w4a8_plan's
# threshold and tiles: at M <= 8 (decode) l_kernel (lowrank.cuh::lr_tile on
# rowdot.cuh's __dp4a walk, 8- or 32-row M tiles); above, w4a8_tile.cuh's
# int8 wgmma tile kernel with the L epilogue on bf16 wgmma, one extra
# sub-step of its ring per (projection a tile touches, 64 ranks).
_L_TILE_RANKS = 64
# the consumers hold a projection window's sub-steps at once: at most the
# ring's depth (csrc/w4a8_tile.cuh::Shape), by tile height
_L_TILE_MAX_CHUNKS = {64: 3, 128: 5}


def _w4a8_l_plan(M: int, N: int, K: int, bits: int, rank: int, splits,
                 sms: int = 132, path: Optional[str] = None,
                 rows: Optional[int] = None) -> dict:
    """How ``csrc/w4a8_lowrank.cu`` runs the L-fused matmul: :func:`_w4a8_plan`
    (``path`` "rowdot", the ``rowdot``-based ``l_kernel``, at M <= 8,
    "tile" above; ``path`` and ``rows`` override it), and for the tile
    path the L epilogue's walk: ``chunks``, sub-steps of 64 ranks (four
    wgmma k16 slices) per projection window; ``rank_pad``, the rank padded
    with zeros to whole sub-steps (a slice skipped under a branch would
    serialize every wgmma of the kernel); ``windows``, the (first, last)
    projection of each 128-row weight tile (a tile straddles projections
    where the splits are not multiples of 128); ``l_steps``, each weight
    tile's L sub-steps. A window's sub-steps
    must fit the ring at once: a rank over 192 takes 128-row tiles, and one
    over 320 raises (as does an override that does not fit)."""
    plan = _w4a8_plan(M, N, K, bits, sms, path, rows)
    if plan["path"] != "tile":
        return plan
    chunks = -(-rank // _L_TILE_RANKS)
    if chunks > _L_TILE_MAX_CHUNKS[plan["rows"]]:
        if rows is not None or chunks > _L_TILE_MAX_CHUNKS[128]:
            raise ValueError(
                f"the L tile path holds at most "
                f"{_L_TILE_RANKS * _L_TILE_MAX_CHUNKS[plan['rows']]} ranks at "
                f"{plan['rows']} rows a tile (and "
                f"{_L_TILE_RANKS * _L_TILE_MAX_CHUNKS[128]} at 128), got "
                f"rank {rank}")
        plan = _w4a8_plan(M, N, K, bits, sms, "tile", 128)
    ends = _split_bounds(splits, N)

    def proj(n):
        return sum(n >= b for b in ends)

    windows = tuple((proj(n0), proj(min(n0 + _W4A8_TILE_BN, N) - 1))
                    for n0 in range(0, N, _W4A8_TILE_BN))
    plan.update(rank_pad=_L_TILE_RANKS * chunks, chunks=chunks,
                windows=windows,
                l_steps=tuple((p1 - p0 + 1) * chunks for p0, p1 in windows))
    return plan


def _launch_l(xq, sx, packed, scales, layer: int, xr, L_cat, L_scale,
              num_bits: int, rank: int, splits, path: Optional[str] = None,
              rows: Optional[int] = None):
    """Launch the L-fused kernel on quantized activations, on the plan of
    :func:`_w4a8_l_plan` (``path`` and ``rows`` passed on to it):
    ``w4a8_l_stacked_launch`` (decode) or ``w4a8_l_tile_launch``. A failed
    launch raises: neither design stands in for the other."""
    M, K = xq.shape
    N = packed.shape[1]
    sx = sx.contiguous()
    if L_cat.dtype != torch.int8:
        raise TypeError(f"L_cat must be int8, got {L_cat.dtype}")
    _check_cuda_operands(xq, sx, packed, scales, xr, L_cat, L_scale)
    index = xq.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = _w4a8_l_plan(M, N, K, num_bits, rank, splits, _sm_count(index),
                        path, rows)
    if plan["path"] == "tile":
        xr_b, L_b = _l_tile_operands(xr, L_cat[layer], rank, len(splits))
        return _launch_l_tile(xq, sx, packed, scales, layer, xr_b, L_b,
                              L_scale, num_bits, rank, splits, plan)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    err = _build.library("w4a8_lowrank").w4a8_l_stacked_launch(
        xq.data_ptr(), sx.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        xr.data_ptr(), L_cat.data_ptr(), L_scale.data_ptr(), out.data_ptr(),
        M, N, K, num_bits, layer, rank, len(splits),
        *_split_bounds(splits, N), _build.stream_ptr(xq.device))
    _build.check(err, "w4a8_l_stacked")
    return out


def _l_tile_operands(xr, L_l, rank: int, n_proj: int):
    """The tile kernel's factor operands, as its TMA boxes read them:
    ``bf16(xr)`` as (M, n_proj, rank8), rounded as the plain version rounds
    it, and :func:`_l_tile_L` of one layer's L codes ``L_l``; rank8 is the
    rank rounded up to a multiple of 8 (16-byte rows), zeros past the
    rank."""
    xr_b = xr.to(torch.bfloat16).view(xr.shape[0], n_proj, rank)
    pad = -rank % 8
    if pad:
        xr_b = torch.nn.functional.pad(xr_b, (0, pad))
    return xr_b, _l_tile_L(L_l, rank)


def _l_tile_L(L_l, rank: int):
    """One layer's L codes ``L_l`` (N, rank) widened to bf16 (exact) as
    (N, rank8) with zeros past the rank: the tile kernel's L operand."""
    L_b = L_l.to(torch.bfloat16)
    pad = -rank % 8
    return torch.nn.functional.pad(L_b, (0, pad)) if pad else L_b


def _launch_l_tile(xq, sx, packed, scales, layer: int, xr_b, L_b, L_scale,
                   num_bits: int, rank: int, splits, plan):
    """Launch ``w4a8_l_tile_launch`` on the operands of
    :func:`_l_tile_operands` with the tile plan of :func:`_w4a8_l_plan`."""
    M, K = xq.shape
    N = packed.shape[1]
    # TMA reads x and the layer's bytes from 16-byte aligned bases: a view
    # off that is copied
    xq, packed = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (xq, packed))
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    err = _build.library("w4a8_lowrank").w4a8_l_tile_launch(
        xq.data_ptr(), sx.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        xr_b.data_ptr(), L_b.data_ptr(), L_scale.data_ptr(), out.data_ptr(),
        M, N, K, num_bits, layer, rank, len(splits),
        *_split_bounds(splits, N), plan["rows"], plan["grid"][0],
        _build.stream_ptr(xq.device))
    _build.check(err, "w4a8_l_tile")
    return out


quantized_matmul_w4a8_l_stacked.launches = 0


def quantized_matmul_w4a8_lr_stacked_plain(
        x: torch.Tensor, packed: torch.Tensor, row_scales: torch.Tensor,
        layer: int, R: torch.Tensor, R_scale: torch.Tensor,
        L_cat: torch.Tensor, L_scale_cat: torch.Tensor, num_bits: int,
        rank: int, splits) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_matmul_w4a8_lr_stacked`:
    :func:`thin_xr` with layer ``layer``'s ``R``, then the l kernel's
    plain version."""
    _require(R.shape[1] == len(splits) * rank,
             f"R {tuple(R.shape)} against splits {tuple(splits)}, rank "
             f"{rank}")
    xr = thin_xr(x, R[layer], R_scale[layer])
    return quantized_matmul_w4a8_l_stacked_plain(
        x, packed, row_scales, layer, xr, L_cat, L_scale_cat, num_bits, rank,
        splits)


def quantized_matmul_w4a8_lr_stacked(
        x: torch.Tensor, packed: torch.Tensor, row_scales: torch.Tensor,
        layer: int, R: torch.Tensor, R_scale: torch.Tensor,
        L_cat: torch.Tensor, L_scale_cat: torch.Tensor, num_bits: int,
        rank: int, splits) -> torch.Tensor:
    """W4A8 matmul plus both halves of the low-rank factors:
    :func:`quantized_matmul_w4a8_l_stacked` with ``xr`` computed by the
    kernels from ``R`` (L, n_proj * rank, K) int8 and ``R_scale`` (L,
    n_proj * rank, 1) f32. Returns (M, N) f32. CUDA tensors go through
    ``csrc/w4a8_lowrank.cu`` on the plan of :func:`_w4a8_lr_plan` (the
    tensor-core ``xr`` kernel, then the L-fused tile kernel on that ``xr``;
    the cooperative ``lr_kernel`` for a rank or K the tile kernel cannot
    hold); CPU tensors through
    :func:`quantized_matmul_w4a8_lr_stacked_plain`.
    """
    if x.device.type == "cpu":
        return quantized_matmul_w4a8_lr_stacked_plain(
            x, packed, row_scales, layer, R, R_scale, L_cat, L_scale_cat,
            num_bits, rank, splits)
    _check_l_args(x, packed, row_scales, layer, L_cat, L_scale_cat,
                  num_bits, splits)
    M, K = x.shape
    nR = len(splits) * rank
    _require(R.shape[1] == nR, f"R {tuple(R.shape)} against splits "
             f"{tuple(splits)}, rank {rank}")
    if (R.dtype != torch.int8 or L_cat.dtype != torch.int8
            or R.shape != (packed.shape[0], nR, K)
            or R_scale.shape != (packed.shape[0], nR, 1)):
        raise ValueError(f"R must be int8 (L, {nR}, {K}) with (L, {nR}, 1) "
                         f"scales and L_cat int8, got R {R.dtype} "
                         f"{tuple(R.shape)}, scales {tuple(R_scale.shape)}, "
                         f"L_cat {L_cat.dtype}")
    _check_lowrank_cuda(num_bits, K, splits)
    xf = x.float().contiguous()
    xq, sx = quantize_activations_int8(xf)
    out, _ = _launch_lr(xf, xq, sx, packed, row_scales.float(), layer, R,
                        R_scale.float().contiguous(), L_cat,
                        L_scale_cat.float().contiguous(), num_bits, rank,
                        splits)
    quantized_matmul_w4a8_lr_stacked.launches += 1
    return out


# The LR-fused matmul's two designs (csrc/w4a8_lowrank.cu): the cooperative
# lr_kernel (phase 1 xr with f32 FMAs, one warp an R row; phase 2
# l_kernel's __dp4a tiles), and two launches: xr_kernel (xr on bf16 wgmma,
# split-K) and then the L-fused tile kernel of _w4a8_l_plan on that xr. On
# an H100 80GB HBM3 (700 W, scripts/torch_w4a8_lr_times.py --sweep) the two
# launches beat lr_kernel at every M from 1 (qkv at M 1: 0.0440 against
# 0.0603 ms; M 8: 0.0423 against 0.1022; gate/up at M 8: 0.0665 against
# 0.1350; M 9: 0.0428 against 0.3621), so decode takes them too. The tile
# path cannot hold a rank over 320 (the L epilogue's ring) or K over 66311
# (its i32 sums of u8 codes), which lr_kernel takes (xr windows in shared
# memory, no ring; rowdot.cuh sums 8-bit codes as u - 127): those shapes run
# lr_kernel at every M.

# xr_kernel's tiles: 128 R rows (two consumer warpgroups) and 16, 64 or 128
# activation rows a CTA, steps of 64 k, blocks of 4 steps chained on one
# accumulator before it joins the running sum; K is split until the grid
# fills the SMs, but no split except the last walks fewer than 4 steps.
# On an H100 80GB HBM3 (700 W, scripts/torch_w4a8_lr_times.py --sweep) 16
# activation rows a tile were fastest up to M 128 (qkv at M 128: 0.0112 ms
# against 0.0162 at 64 and 0.0201 at 128 rows), 64 at M 512 (0.0174
# against 0.0210 at 16 and 0.0209 at 128) and 128 at M 2048 (0.0290
# against 0.0336 at 64 and 0.0645 at 16).
_XR_COLS = ((128, 16), (1024, 64))
_XR_ROWS = 128
_XR_BK = 64
_XR_BLOCK_STEPS = 4


def _xr_plan(M: int, nR: int, K: int, sms: int = 132,
             cols: Optional[int] = None,
             split_steps: Optional[int] = None) -> dict:
    """How ``xr_kernel`` of ``csrc/w4a8_lowrank.cu`` computes ``(bf16(x)
    @ R.T) * Rs`` for x (M, K) and R (nR, K): ``tiles`` of 128 R rows and
    ``cols`` activation rows (16 at M <= 128, 64 at M <= 1024, else 128),
    each walking the ``ceil(K / 64)`` steps of 64 k in ``splits`` CTAs of
    ``split_steps`` steps, the last possibly shorter; ``workspace`` f32 hold
    the partial tiles when ``splits`` > 1. The split count is the most that
    keeps the grid within one CTA per SM, but no split except the last
    walks fewer than 4 steps. ``cols`` and ``split_steps`` override the
    choice (for tuning)."""
    k_steps = -(-K // _XR_BK)
    if cols is None:
        cols = next((c for m, c in _XR_COLS if M <= m), 128)
    if cols not in (16, 64, 128):
        raise ValueError(f"the xr kernel takes 16, 64 or 128 activation "
                         f"rows a CTA, got {cols}")
    grid_nm = (-(-nR // _XR_ROWS), -(-M // cols))
    tiles = grid_nm[0] * grid_nm[1]
    plan = _split_k(tiles, _XR_ROWS, cols, k_steps, sms // tiles, split_steps)
    return dict(cols=cols, grid=grid_nm + (plan["splits"],), **plan)


def _w4a8_lr_plan(M: int, N: int, K: int, bits: int, rank: int, splits,
                  sms: int = 132, path: Optional[str] = None,
                  rows: Optional[int] = None,
                  xr_cols: Optional[int] = None,
                  xr_split_steps: Optional[int] = None) -> dict:
    """How ``csrc/w4a8_lowrank.cu`` runs the LR-fused matmul: ``path``
    "tile" at every M where the L tile path holds the rank and K: ``xr``,
    the plan of :func:`_xr_plan` for ``xr_kernel`` (nR = n_proj * rank rows
    of R), and the rest the L-fused tile path's plan of
    :func:`_w4a8_l_plan` (its tiles, rank padding, projection windows);
    ``path`` "coop" (the cooperative ``lr_kernel``, ``rows`` = 8 or 32
    activation rows a tile) for a rank over 320 or K over 66311. ``path``,
    ``rows``, ``xr_cols`` and ``xr_split_steps`` override the choice (for
    tuning and for comparing the two designs); a forced tile path raises
    where it cannot hold the shape."""
    if path is None:
        fits = (-(-rank // _L_TILE_RANKS) <= _L_TILE_MAX_CHUNKS[128]
                and K <= _W4A8_TILE_MAX_K)
        path = "tile" if fits else "coop"
    if path == "coop":
        return dict(path=path, rows=8 if M <= 8 else 32)
    if path != "tile":
        raise ValueError(f"unknown LR-fused path {path!r}")
    plan = _w4a8_l_plan(M, N, K, bits, rank, splits, sms, "tile", rows)
    plan["xr"] = _xr_plan(M, len(splits) * rank, K, sms, xr_cols,
                          xr_split_steps)
    return plan


def _launch_lr_xr(xb, R_l, Rs_l, rank: int, plan: dict):
    """Launch ``w4a8_lr_xr_launch`` on bf16 activations ``xb`` and one
    layer's R codes ``R_l`` (nR, K) int8 and scales ``Rs_l`` (nR, 1) f32,
    on an :func:`_xr_plan` (a split-K workspace from ``torch.empty``,
    counters from :func:`_split_counters`). Returns ``xr`` (M, nR) f32 and
    its bf16 rounding as the L tile kernel reads it, (M, nR / rank, rank8)
    as :func:`_l_tile_operands` makes it (zeros past the rank)."""
    M, K = xb.shape
    nR = R_l.shape[0]
    _check_cuda_operands(xb, R_l, Rs_l)
    # TMA reads x and R from 16-byte aligned bases
    xb, R_l = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xb, R_l))
    xr = torch.empty((M, nR), dtype=torch.float32, device=xb.device)
    rank8 = -(-rank // 8) * 8
    xr_b = (torch.empty if rank8 == rank else torch.zeros)(
        (M, nR // rank, rank8), dtype=torch.bfloat16, device=xb.device)
    ws = counters = None
    if plan["splits"] > 1:
        ws = torch.empty(plan["workspace"], dtype=torch.float32,
                         device=xb.device)
        counters = _split_counters(xb.device, plan["tiles"])
    err = _build.library("w4a8_lowrank").w4a8_lr_xr_launch(
        xb.data_ptr(), R_l.data_ptr(), Rs_l.data_ptr(), xr.data_ptr(),
        xr_b.data_ptr(), None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), M, nR, K, rank,
        plan["cols"], plan["split_steps"], plan["splits"],
        _build.stream_ptr(xb.device))
    _build.check(err, "w4a8_lr_xr")
    return xr, xr_b


def _launch_lr(xf, xq, sx, packed, scales, layer: int, R, Rs, L_cat, Ls,
               num_bits: int, rank: int, splits, path: Optional[str] = None,
               rows: Optional[int] = None, **xr_kw):
    """Launch the LR-fused matmul on f32 activations ``xf`` and their int8
    codes, on the plan of :func:`_w4a8_lr_plan` (``path``, ``rows`` and
    ``xr_cols`` / ``xr_split_steps`` passed on to it): the cooperative
    ``w4a8_lr_stacked_launch``, or ``w4a8_lr_xr_launch`` and then
    ``w4a8_l_tile_launch`` on its ``xr``. Returns the output and that
    ``xr``. A failed launch raises: neither design stands in for the
    other."""
    M, K = xq.shape
    N = packed.shape[1]
    sx = sx.contiguous()
    if xf.data_ptr() % 16:      # the kernels read x with 16-byte loads
        xf = xf.clone()
    _check_cuda_operands(xf, xq, sx, packed, scales, R, Rs, L_cat, Ls)
    index = xq.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = _w4a8_lr_plan(M, N, K, num_bits, rank, splits, _sm_count(index),
                         path, rows, **xr_kw)
    if plan["path"] == "tile":
        xr, xr_b = _launch_lr_xr(xf.to(torch.bfloat16), R[layer], Rs[layer],
                                 rank, plan["xr"])
        return _launch_l_tile(xq, sx, packed, scales, layer, xr_b,
                              _l_tile_L(L_cat[layer], rank), Ls, num_bits,
                              rank, splits, plan), xr
    xr = torch.empty((M, len(splits) * rank), dtype=torch.float32,
                     device=xq.device)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    err = _build.library("w4a8_lowrank").w4a8_lr_stacked_launch(
        xf.data_ptr(), xq.data_ptr(), sx.data_ptr(), packed.data_ptr(),
        scales.data_ptr(), R.data_ptr(), Rs.data_ptr(), L_cat.data_ptr(),
        Ls.data_ptr(), xr.data_ptr(), out.data_ptr(), M, N, K, num_bits,
        layer, rank, len(splits), *_split_bounds(splits, N),
        _build.stream_ptr(xq.device))
    _build.check(err, "w4a8_lr_stacked")
    return out, xr


quantized_matmul_w4a8_lr_stacked.launches = 0


def _check_mlp_args(x, gu_packed, gu_scales, layer: int, xr_gu, gu_L_cat,
                    gu_L_scale, gu_gs, dn_packed, dn_scales, dn_R,
                    dn_R_scale, dn_L, dn_L_scale, num_bits: int, rank: int,
                    block_m: int):
    f = _pack_factor(num_bits)
    M, K = x.shape
    Lk, N_gu = gu_packed.shape[:2]
    im = N_gu // 2
    h = dn_packed.shape[1]
    _require(gu_packed.shape[2] * f == K and dn_packed.shape[2] * f == im,
             f"gate/up {tuple(gu_packed.shape)} and down "
             f"{tuple(dn_packed.shape)} against K={K} at {num_bits}-bit")
    _require(gu_packed.dtype == torch.uint8
             and dn_packed.dtype == torch.uint8, "packed codes must be uint8")
    _require(tuple(xr_gu.shape) == (M, 2 * rank),
             f"xr_gu {tuple(xr_gu.shape)} against rank {rank}")
    _require(tuple(dn_R.shape[1:]) == (rank, im),
             f"dn_R {tuple(dn_R.shape)} against rank {rank}, im {im}")
    if M > block_m:
        raise ValueError("mlp megakernel supports one row block "
                         f"(M={M} > block_m={block_m})")
    shapes = {"gu_scales": (gu_scales, (Lk, N_gu, 1)),
              "gu_L_cat": (gu_L_cat, (Lk, N_gu, rank)),
              "gu_L_scale": (gu_L_scale, (Lk, N_gu, 1)),
              "gu_gs": (gu_gs, (Lk, 2)), "dn_scales": (dn_scales, (Lk, h, 1)),
              "dn_R": (dn_R, (Lk, rank, im)),
              "dn_R_scale": (dn_R_scale, (Lk, rank, 1)),
              "dn_L": (dn_L, (Lk, h, rank)),
              "dn_L_scale": (dn_L_scale, (Lk, h, 1))}
    bad = {k: tuple(t.shape) for k, (t, want) in shapes.items()
           if tuple(t.shape) != want}
    if bad or dn_packed.shape[0] != Lk:
        raise ValueError(f"shape mismatch: {bad}, down "
                         f"{tuple(dn_packed.shape)}")
    if not 0 <= layer < Lk:
        raise IndexError(f"layer {layer} out of range for {Lk} layers")
    return M, K, im, h


def quantized_matmul_w4a8_mlp_stacked_plain(
        x, gu_packed, gu_scales, layer: int, xr_gu, gu_L_cat, gu_L_scale,
        gu_gs, dn_packed, dn_scales, dn_R, dn_R_scale, dn_L, dn_L_scale,
        num_bits: int, rank: int, block_m: int = 128) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_matmul_w4a8_mlp_stacked`,
    in the reference kernel's order: gate/up through the l kernel's plain
    version times their global scales, ``m = (g * sigmoid(g)) * u``, the
    per-row int8 requantization of ``m`` (absmax floor 1e-12, / 127),
    ``xrd = (bf16(m) @ bf16(dnR).T) * dnRs``, then down with the L
    epilogue on ``xrd``."""
    return _mlp_plain_parts(
        x, gu_packed, gu_scales, layer, xr_gu, gu_L_cat, gu_L_scale, gu_gs,
        dn_packed, dn_scales, dn_R, dn_R_scale, dn_L, dn_L_scale, num_bits,
        rank, block_m)["out"]


def _mlp_plain_parts(x, gu_packed, gu_scales, layer: int, xr_gu, gu_L_cat,
                     gu_L_scale, gu_gs, dn_packed, dn_scales, dn_R,
                     dn_R_scale, dn_L, dn_L_scale, num_bits: int, rank: int,
                     block_m: int = 128):
    """:func:`quantized_matmul_w4a8_mlp_stacked_plain` with its
    intermediates: ``m``, its int8 codes ``m8`` and the output ``out``."""
    M, K, im, h = _check_mlp_args(
        x, gu_packed, gu_scales, layer, xr_gu, gu_L_cat, gu_L_scale, gu_gs,
        dn_packed, dn_scales, dn_R, dn_R_scale, dn_L, dn_L_scale, num_bits,
        rank, block_m)
    gu = quantized_matmul_w4a8_l_stacked_plain(
        x, gu_packed, gu_scales, layer, xr_gu, gu_L_cat, gu_L_scale,
        num_bits, rank, (im, im))
    gs = gu_gs[layer].float()
    g = gu[:, :im] * gs[0]
    m = (g * torch.sigmoid(g)) * (gu[:, im:] * gs[1])
    mq, sm = quantize_activations_int8(m)
    xrd = thin_xr(m, dn_R[layer], dn_R_scale[layer])
    return dict(m=m, m8=mq, out=_l_from_codes(
        mq, sm, dn_packed, dn_scales, layer, xrd, dn_L, dn_L_scale, num_bits,
        rank, (h,)))


def quantized_matmul_w4a8_mlp_stacked(
        x, gu_packed, gu_scales, layer: int, xr_gu, gu_L_cat, gu_L_scale,
        gu_gs, dn_packed, dn_scales, dn_R, dn_R_scale, dn_L, dn_L_scale,
        num_bits: int, rank: int, block_m: int = 128) -> torch.Tensor:
    """Whole-MLP W4A8 decode, ``down(silu(gate(x)) * up(x))``, in one launch
    against layer ``layer`` of the stacked weights.

    ``x`` (M, h) f32, the normed layer input (M <= ``block_m``: the
    reference's one row block); ``gu_*`` the fused gate ++ up projection
    (packed (L, 2 im, h/f), scales (L, 2 im, 1), ``L_cat`` (L, 2 im, rank)
    int8 with (L, 2 im, 1) scales, global scales ``gu_gs`` (L, 2)); ``xr_gu``
    (M, 2 rank) f32, the caller's thin gate/up ``R`` contraction; ``dn_*``
    down_proj (packed (L, h, im/f), scales, ``R`` (L, rank, im) and ``L``
    (L, h, rank) int8 codes with their scales). Returns down's (M, h)
    output before its global scale. CUDA tensors go through the cooperative
    kernel of ``csrc/w4a8_lowrank.cu``; CPU tensors through
    :func:`quantized_matmul_w4a8_mlp_stacked_plain`.
    """
    args = (x, gu_packed, gu_scales, layer, xr_gu, gu_L_cat, gu_L_scale,
            gu_gs, dn_packed, dn_scales, dn_R, dn_R_scale, dn_L, dn_L_scale,
            num_bits, rank, block_m)
    if x.device.type == "cpu":
        return quantized_matmul_w4a8_mlp_stacked_plain(*args)
    M, K, im, h = _check_mlp_args(*args)
    _check_lowrank_cuda(num_bits, K, (im,))
    _check_lowrank_cuda(num_bits, im, (h,))
    if gu_L_cat.dtype != torch.int8 or dn_R.dtype != torch.int8 \
            or dn_L.dtype != torch.int8:
        raise TypeError("the L and R factors must be int8 codes")
    if rank % _FKC or h % 32 or im % 16:
        raise ValueError(f"the CUDA kernel takes rank % 128 == 0, h % 32 == "
                         f"0 and im % 16 == 0; got rank {rank}, h {h}, "
                         f"im {im}")
    xq, sx = quantize_activations_int8(x)
    out, _ = _launch_mlp(xq, sx, xr_gu, gu_packed, gu_scales, layer,
                         gu_L_cat, gu_L_scale, gu_gs, dn_packed, dn_scales,
                         dn_R, dn_R_scale, dn_L, dn_L_scale, num_bits, rank)
    quantized_matmul_w4a8_mlp_stacked.launches += 1
    return out


# The projection stages of the cooperative fusion kernels (the whole-MLP
# kernel, attention + o_proj: csrc/fused_proj.cuh): packed bytes a slab,
# int4s of a warp's two split-group partial slots per 8 activation rows,
# warps of the whole-MLP kernel's CTAs and of attention + o_proj's.
_FKC, _FUSED_SLOT = 128, 2 * 2 * 2 * 32
_MLP_WARPS, _ATTN_O_WARPS = 8, 4


def _fused_rows(M: int) -> int:
    """Activation rows of a tile of the fusion kernels (``MT``): 8 up to 8
    rows, else 32 (several tiles above 32)."""
    return 8 if M <= 8 else 32


def _fused_stage(K: int, N: int, rank: int, num_bits: int, rows: int,
                 gate_up: bool = False) -> dict:
    """A projection stage as ``fused_proj.cuh``'s ``Stage`` holds it: rows
    of ``P`` packed bytes in ``nk`` code slabs of 128 bytes and ``nl`` L
    slabs a group; ``groups`` groups of two 16-row tiles (32 consecutive
    rows of N, or for gate/up (N = im) 16 gate rows and the same up rows,
    ``half`` = im apart) for each of ``mtiles`` activation tiles of ``MT``
    rows."""
    P = K // _pack_factor(num_bits)
    MT = _fused_rows(rows)
    return dict(P=P, nk=-(-P // _FKC), nl=rank // _FKC,
                groups=N // 16 if gate_up else N // 32,
                half=N if gate_up else 0, mtiles=-(-rows // MT), rows=rows,
                MT=MT)


def _fused_group_rows(st: dict, g: int):
    """The first rows of group ``g``'s two 16-row tiles (``group_rows``)."""
    if st["half"]:
        return 16 * g, st["half"] + 16 * g
    return 32 * g, 32 * g + 16


def _fused_slabs(st: dict) -> int:
    return st["mtiles"] * st["groups"] * (st["nk"] + st["nl"])


def _fused_range(S: int, w: int, W: int):
    """Warp ``w``'s slabs ``[lo, hi)`` of a stage's ``S`` cut ``W`` ways."""
    return S * w // W, S * (w + 1) // W


def _fused_owner(s: int, S: int, W: int) -> int:
    """The warp whose range holds slab ``s``."""
    return ((s + 1) * W - 1) // S


def _fused_contributors(G: int, per: int, S: int, W: int):
    """The warps whose slabs make up group ``G`` in the order ``split_sum``
    sums their partials: the owner of its first slab, then the owner of
    the slab after each one's range."""
    out, s = [], G * per
    while s < (G + 1) * per:
        out.append(_fused_owner(s, S, W))
        s = _fused_range(S, out[-1] + 1, W)[0]
    return out


def _mlp_plan(M: int, h: int, im: int, rank: int, num_bits: int):
    """The whole-MLP kernel's two stages (``mlp_plan``): gate/up, then
    down."""
    return (_fused_stage(h, im, rank, num_bits, M, gate_up=True),
            _fused_stage(im, h, rank, num_bits, M))


def _mlp_xrd_terms(groups: int, MT: int):
    """The order in which the whole-MLP kernel's phase 2 sums one xrd
    output's group partials (the same for every output column and tile):
    warp ``w`` of the CTA takes groups ``[w G / 8, (w + 1) G / 8)``, its
    lanes of one row every ``32 / MT``-th of them (lane ``gs`` from the
    range's start + gs), each lane a chain in that order; then the lanes by
    a butterfly over ``gs`` and the warps in order. Returns, per warp, the
    lane chains: ``[[[g, ...] for gs] for w]``."""
    GS = 32 // MT
    out = []
    for w in range(_MLP_WARPS):
        lo, hi = _fused_range(groups, w, _MLP_WARPS)
        out.append([list(range(lo + gs, hi, GS)) for gs in range(GS)])
    return out


_FUSED_GRIDS: dict = {}


def _fused_grid(entry: str, device: torch.device, *key) -> int:
    """The most CTAs of a cooperative launch of the fusion kernels (the C
    entry ``entry`` of ``key``: occupancy x SMs), once per device and key."""
    k = (entry, device.index, *key)
    if k not in _FUSED_GRIDS:
        lib = "w4a8_lowrank" if entry == "w4a8_mlp_grid" else "attn_o"
        n = ctypes.c_int(0)
        _build.check(getattr(_build.library(lib), entry)(
            *key, ctypes.byref(n)), entry)
        _FUSED_GRIDS[k] = n.value
    return _FUSED_GRIDS[k]


def _fused_pws(device: torch.device, warps: int, MT: int) -> torch.Tensor:
    """Split-group partial slots of a launch of ``warps`` warps (int32)."""
    return torch.empty((warps * _FUSED_SLOT * (MT // 8) * 4,),
                       dtype=torch.int32, device=device)


def _launch_mlp(xq, sx, xr_gu, gu_packed, gu_scales, layer: int, gu_L_cat,
                gu_L_scale, gu_gs, dn_packed, dn_scales, dn_R, dn_R_scale,
                dn_L, dn_L_scale, num_bits: int, rank: int, ctas: int = 0):
    """Launch ``w4a8_mlp_stacked_launch`` on quantized activations (on
    ``ctas`` CTAs; 0: the cooperative grid); returns the output and the
    kernel's scratch (``m`` and its int8 codes ``m8`` among it)."""
    M = xq.shape[0]
    im, h = gu_packed.shape[1] // 2, dn_packed.shape[1]
    sx = sx.contiguous()
    fl = [t.float().contiguous() for t in (xr_gu, gu_scales, gu_L_scale,
                                           gu_gs, dn_scales, dn_R_scale,
                                           dn_L_scale)]
    xr_f, gu_s, gu_Ls, gs, dn_s, dn_Rs, dn_Ls = fl
    _check_cuda_operands(xq, sx, gu_packed, gu_L_cat, dn_packed, dn_R, dn_L,
                         *fl)
    dev = xq.device
    gu, dn = _mlp_plan(M, h, im, rank, num_bits)
    MT, G = gu["MT"], gu["mtiles"] * gu["groups"]
    grid = _fused_grid("w4a8_mlp_grid", dev, M, num_bits)
    grid = min(ctas, grid) if ctas else grid
    scratch = dict(
        m=torch.empty((M, im), dtype=torch.float32, device=dev),
        m8=torch.empty((M, im), dtype=torch.int8, device=dev),
        amax=torch.empty((G, MT), dtype=torch.float32, device=dev),
        xpart=torch.empty((G, rank, MT), dtype=torch.float32, device=dev),
        xrd=torch.empty((M, rank), dtype=torch.float32, device=dev),
        pws=_fused_pws(dev, grid * _MLP_WARPS, MT),
        cnt=_split_counters(dev, max(G, dn["mtiles"] * dn["groups"])))
    out = torch.empty((M, h), dtype=torch.float32, device=dev)
    err = _build.library("w4a8_lowrank").w4a8_mlp_stacked_launch(
        xq.data_ptr(), sx.data_ptr(), xr_f.data_ptr(), gu_packed.data_ptr(),
        gu_s.data_ptr(), gu_L_cat.data_ptr(), gu_Ls.data_ptr(),
        gs.data_ptr(), dn_packed.data_ptr(), dn_s.data_ptr(),
        dn_R.data_ptr(), dn_Rs.data_ptr(), dn_L.data_ptr(), dn_Ls.data_ptr(),
        *(scratch[k].data_ptr() for k in ("m", "m8", "amax", "xpart", "xrd",
                                          "pws", "cnt")),
        out.data_ptr(), M, h, im, num_bits, layer, rank, grid,
        _build.stream_ptr(dev))
    _build.check(err, "w4a8_mlp_stacked")
    return out, scratch


quantized_matmul_w4a8_mlp_stacked.launches = 0


# ---------------------------------------------------------------------------
# W4A8 flat matmul (replaces the TPU kernel #2)
# ---------------------------------------------------------------------------

def quantized_matmul_w4a8_plain(x: torch.Tensor, packed: torch.Tensor,
                                row_scales: torch.Tensor,
                                num_bits: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantized_matmul_w4a8` (the exact
    integer sum of the stacked kernel's plain version on one layer)."""
    return quantized_matmul_w4a8_stacked_plain(
        x, packed[None], row_scales[None], 0, num_bits)


# the reference's XLA twin is the same function
quantized_matmul_w4a8_xla = quantized_matmul_w4a8_plain


def quantized_matmul_w4a8(x: torch.Tensor, packed: torch.Tensor,
                          row_scales: torch.Tensor,
                          num_bits: int) -> torch.Tensor:
    """W4A8 matmul against a flat packed weight: ``x`` (M, K) float,
    quantized to int8 per row; ``packed`` (N, K/f) uint8; ``row_scales``
    (N, 1) f32. Returns (M, N) f32. CUDA tensors go through the flat entry
    of ``csrc/w4a8_stacked.cu`` (the stacked kernel's device code, on the
    plan of :func:`_w4a8_plan`); CPU tensors through
    :func:`quantized_matmul_w4a8_plain`.
    """
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    f = _pack_factor(num_bits)
    M, K = x.shape
    N, P = packed.shape
    if P * f != K or row_scales.shape != (N, 1):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scales "
                         f"{tuple(row_scales.shape)} at {num_bits}-bit")
    if x.device.type == "cpu":
        return quantized_matmul_w4a8_plain(x, packed, row_scales, num_bits)
    if num_bits not in (2, 4, 8) or K % (16 * f):
        raise ValueError(f"the CUDA kernel takes 2/4/8-bit codes with "
                         f"K % {16 * f} == 0, got {num_bits}-bit K={K}")
    xq, sx = quantize_activations_int8(x)
    out = _launch_w4a8_stacked(xq, sx, packed, row_scales.float(), None,
                               num_bits)
    quantized_matmul_w4a8.launches += 1
    return out


quantized_matmul_w4a8.launches = 0


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
    CUDA tensors go through ``csrc/int8_matmul.cu``'s int8 ``wgmma`` tile
    kernel on the plan of :func:`_int8_plan` (swapped, weight-bytes bound,
    up to M 64; operation-bound tiles above); CPU tensors through
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


# The CUDA kernel (csrc/int8_matmul.cu): TMA and int8 wgmma m64nNk32
# s32.s8.s8, persistent CTAs, 128-byte k steps. Up to M 64 it is swapped:
# 128 weight rows as wgmma's A operand and the M activation rows as its 64
# columns, bound by the weight bytes. Above, 128 activation rows and 128 or
# 256 weight rows a tile, bound by the int8 operations, the output leaving
# through TMA stores (N % 4 == 0; the swapped tiles, in M tiles of 64, take
# any other N). The i32 sums hold while K <= 2^31 / 127^2.
# On an H100 80GB HBM3 (700 W, scripts/torch_int8_times.py --sweep, the
# Llama-2-7B head 32000 x 4096) the tile kernel beat the rowdot kernel it
# replaced (__dp4a, one warp a weight row) at every M from 1 (M 1: 0.0460
# against 0.0560 ms; M 8: 0.0467 against 0.0722; M 32: 0.0492 against
# 0.7890); swapped tiles of 8, 16 or 32 columns were at most 2.5% faster
# than the 64-column tile at the M they hold (M 8: 0.0470 against 0.0481
# ms; M 16: 0.0478 against 0.0490), so one width serves; 256-row weight
# tiles beat 128 by 3-5% at M 512 to 2048 (M 1024: 0.2108 against 0.2224
# ms) and lost by 1-2% at M 96, 128 and 256, where they leave fewer than two
# tiles an SM.
_INT8_SWAP_ROWS = 64
_INT8_TILE_MAX_K = (2 ** 31 - 1) // (127 * 127)


def _int8_plan(M: int, N: int, K: int, sms: int = 132,
               rows: Optional[int] = None,
               cols: Optional[int] = None) -> dict:
    """How ``csrc/int8_matmul.cu`` runs ``(M, K) @ W.T`` with ``W`` (N, K)
    int8: tiles of ``rows`` activation rows and ``cols`` weight rows,
    ``swap`` where ``rows`` is 64 (M <= 64, or N % 4 != 0: the weights are
    wgmma's A operand, 128 rows a tile, the activations its 64 columns),
    else 128 activation rows by 256 weight rows where that still makes at
    least two tiles an SM and 128 otherwise (the TMA stores need N % 4 ==
    0). ``tiles`` = (A tiles, B tiles), walked A fastest; ``grid`` one
    persistent CTA a tile, at most one an SM. ``rows`` and ``cols``
    override the choice (for tuning and for the tests). Raises where the
    i32 sums could overflow (K over 133144)."""
    if K > _INT8_TILE_MAX_K:
        raise ValueError(f"the int8 tile kernel's i32 sums hold K <= "
                         f"{_INT8_TILE_MAX_K} (127 x 127 per product), got "
                         f"K={K}")
    if rows is None:
        rows = (_INT8_SWAP_ROWS if M <= _INT8_SWAP_ROWS or N % 4
                else 128)
    if rows not in (_INT8_SWAP_ROWS, 128):
        raise ValueError(f"the int8 tile kernel takes 64 (swapped) or 128 "
                         f"activation rows a tile, got {rows}")
    swap = rows == _INT8_SWAP_ROWS
    if cols is None:
        wide = -(-M // 128) * -(-N // 256)
        cols = 256 if not swap and wide >= 2 * sms else 128
    if (swap and cols != 128) or (not swap and cols not in (128, 256)):
        raise ValueError(f"the int8 tile kernel takes 128 weight rows a "
                         f"swapped tile and 128 or 256 otherwise, got rows "
                         f"{rows}, cols {cols}")
    if not swap and N % 4:
        raise ValueError(f"the int8 tile kernel's TMA stores need N % 4 == "
                         f"0 at 128 activation rows a tile, got N={N}")
    tiles = ((-(-N // cols), -(-M // rows)) if swap
             else (-(-M // rows), -(-N // cols)))
    return dict(swap=swap, rows=rows, cols=cols, tiles=tiles,
                grid=(min(tiles[0] * tiles[1], sms),))


def _launch_int8_matmul(xq, sx, w_int8, scales, rows: Optional[int] = None,
                        cols: Optional[int] = None):
    """Launch ``csrc/int8_matmul.cu`` on quantized activations, on the plan
    of :func:`_int8_plan` (``rows`` and ``cols`` passed on to it). A failed
    launch raises."""
    M, K = xq.shape
    N = w_int8.shape[0]
    sx = sx.contiguous()
    _check_cuda_operands(xq, sx, w_int8, scales)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    lib = _build.library("int8_matmul")
    stream = _build.stream_ptr(xq.device)
    index = xq.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = _int8_plan(M, N, K, _sm_count(index), rows, cols)
    # TMA reads xq and w from 16-byte aligned bases: a view off that
    # alignment is copied
    xq, w_int8 = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (xq, w_int8))
    err = lib.int8_tile_launch(
        xq.data_ptr(), sx.data_ptr(), w_int8.data_ptr(), scales.data_ptr(),
        out.data_ptr(), M, N, K, plan["rows"], plan["cols"], plan["grid"][0],
        stream)
    _build.check(err, "int8_tile")
    return out


int8_matmul.launches = 0


# ---------------------------------------------------------------------------
# Stacked bf16 matmul (replaces the TPU kernel #8)
# ---------------------------------------------------------------------------

def bf16_matmul_stacked_plain(x: torch.Tensor, W: torch.Tensor,
                              layer: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`bf16_matmul_stacked`: an f32 matmul
    of the bf16 operands (each product exact in f32; TF32 is off for f32
    matmuls by PyTorch's default)."""
    return _bf16(x) @ W[layer].float().T


# The CUDA kernel's tiles (csrc/bf16_gemm.cu): k steps of 64 values; split-K
# tiles of 64 weight rows (a ring of 4 stages, several CTAs an SM) at M <= 16,
# 128 x 128 output tiles (6 stages, one CTA an SM) above. A split walks at
# least 8 steps, two 4-stage rings: a shorter walk does not pay for writing
# and summing its partial tile (R 128 x 4096 at M 8 took 0.0113 ms in 64
# splits of one step, 0.0058 in 8 of eight on an H100 80GB HBM3 at 700 W;
# scripts/torch_bf16_stacked_times.py --sweep).
_BF16_BK = 64
_BF16_MIN_SPLIT_STEPS = 8
_BF16_SPLIT_MAX_M = 16


def _bf16_stacked_plan(M: int, N: int, K: int, sms: int = 132,
                       split_steps: Optional[int] = None) -> dict:
    """How ``csrc/bf16_gemm.cu`` runs ``(M, K) @ (N, K).T``: ``path``
    "splitk" at M <= 16 (swap-AB: 64 weight rows per CTA, the M activation
    rows as wgmma's ``cols`` = 8 or 16 columns) or "tiled" above (128 x 128
    output tiles); either walks K in ``splits`` CTAs of ``split_steps``
    64-value steps each, the last possibly shorter, and ``workspace`` f32
    hold their partial tiles when ``splits`` > 1. ``grid`` is the launch's
    (x, y) or (x, y, z). The split count is the least that brings the grid
    to ``sms`` CTAs (splitk: several fit an SM) or the most that keeps it
    within one CTA per SM (tiled), but no split except the last walks fewer
    than 8 steps, so a K of under 16 steps is not split. ``split_steps``
    overrides the steps per split (for tuning)."""
    k_steps = -(-K // _BF16_BK)
    if M <= _BF16_SPLIT_MAX_M:
        tiles, rows, cols = -(-N // 64), 64, 8 if M <= 8 else 16
        want = -(-sms // tiles)
    else:
        tiles, rows, cols = -(-N // 128) * -(-M // 128), 128, 128
        want = sms // tiles
    if split_steps is None:
        splits = max(1, min(want, k_steps // _BF16_MIN_SPLIT_STEPS))
        split_steps = -(-k_steps // splits)
    split_steps = min(split_steps, k_steps)
    splits = -(-k_steps // split_steps)
    if M <= _BF16_SPLIT_MAX_M:
        path, grid = "splitk", (tiles, splits)
    else:
        path, grid = "tiled", (-(-N // 128), -(-M // 128), splits)
    return dict(path=path, rows=rows, cols=cols, splits=splits,
                split_steps=split_steps, grid=grid,
                workspace=splits * tiles * rows * cols if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bf16_matmul_stacked(x: torch.Tensor, W: torch.Tensor,
                        layer: int) -> torch.Tensor:
    """``y = bf16(x) @ W[layer].T`` in f32 with the layer selected by a
    pointer offset (no copy of the slab).

    ``x`` (M, K) float, cast to bf16; ``W`` (L, N, K) bf16. Returns (M, N)
    f32. CUDA tensors go through ``bf16_stacked_launch`` of
    ``csrc/bf16_gemm.cu`` (TMA and bf16 ``wgmma`` with f32 accumulators,
    on the plan of :func:`_bf16_stacked_plan`); CPU tensors through
    :func:`bf16_matmul_stacked_plain`. Neither package calls it on its
    serving paths; it is the reference's kernel for factor matmuls.
    """
    if W.dtype != torch.bfloat16:
        raise TypeError(f"W must be bf16, got {W.dtype}")
    M, K = x.shape
    Lk, N, Kw = W.shape
    if Kw != K:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, W "
                         f"{tuple(W.shape)}")
    if not 0 <= layer < Lk:
        raise IndexError(f"layer {layer} out of range for {Lk} layers")
    if x.device.type == "cpu":
        return bf16_matmul_stacked_plain(x, W, layer)
    if K % 8:
        raise ValueError(f"the CUDA kernel's TMA needs 16-byte row strides: "
                         f"K % 8 == 0, got K={K}")
    out = _launch_bf16_stacked(x.to(torch.bfloat16).contiguous(), W, layer)
    bf16_matmul_stacked.launches += 1
    return out


def _launch_bf16_stacked(xb, W, layer: int,
                         split_steps: Optional[int] = None):
    """Launch ``bf16_stacked_launch`` of ``csrc/bf16_gemm.cu`` on bf16
    activations against layer ``layer`` of ``W``, on the plan of
    :func:`_bf16_stacked_plan` (a split-K workspace from ``torch.empty``)."""
    M, K = xb.shape
    N = W.shape[1]
    _check_cuda_operands(xb, W)
    if xb.data_ptr() % 16 or W.data_ptr() % 16:
        raise ValueError("the CUDA kernel's TMA needs x and W 16-byte "
                         "aligned")
    index = xb.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = _bf16_stacked_plan(M, N, K, _sm_count(index), split_steps)
    out = torch.empty((M, N), dtype=torch.float32, device=xb.device)
    ws = None
    if plan["workspace"]:
        ws = torch.empty(plan["workspace"], dtype=torch.float32,
                         device=xb.device)
    err = _build.library("bf16_gemm").bf16_stacked_launch(
        xb.data_ptr(), W.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, layer,
        0 if plan["path"] == "splitk" else 1, plan["cols"],
        plan["split_steps"], plan["splits"], _build.stream_ptr(xb.device))
    _build.check(err, "bf16_stacked")
    return out


bf16_matmul_stacked.launches = 0


def low_rank_matmul(x2: torch.Tensor, L: torch.Tensor, R: torch.Tensor,
                    L_scale: Optional[torch.Tensor] = None,
                    R_scale: Optional[torch.Tensor] = None,
                    xr_reduce=None) -> torch.Tensor:
    """``x2 @ (L @ R).T`` as two thin dots, factors bf16 or int8 codes.

    As in the reference, ``x2`` and ``xr`` round to bf16 before each dot and
    the dots accumulate in f32 (operands upcast, exact for bf16 values);
    int8 factors dequantize as rank-1 column rescales. ``L`` (N, r), ``R``
    (r, K), scales (N, 1) / (r, 1). ``xr_reduce``, when given, maps the f32
    ``xr`` before its bf16 cast: a tensor-parallel caller sums the K-shards'
    partial ``xr`` there, so the cast sees the full-K value.
    """
    def bf16(t):
        return t.to(torch.bfloat16).float()

    xr = bf16(x2) @ bf16(R).T
    if R_scale is not None:
        xr = xr * R_scale[:, 0][None, :]
    if xr_reduce is not None:
        xr = xr_reduce(xr)
    ylr = bf16(xr) @ bf16(L).T
    if L_scale is not None:
        ylr = ylr * L_scale[:, 0][None, :]
    return ylr


# ---------------------------------------------------------------------------
# Fast Walsh-Hadamard transform (the Hadamard incoherence rotations of model
# surgery; plain torch butterflies, not a kernel of the reference)
# ---------------------------------------------------------------------------

def fwht(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Unnormalized fast Walsh-Hadamard transform along ``axis`` (length a
    power of two): ``scipy.linalg.hadamard(n) @ x`` in O(n log n); divide by
    ``sqrt(n)`` for the orthonormal transform."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT length {n} is not a power of two")
    shape = x.shape
    h = 1
    while h < n:
        x = x.reshape(*shape[:-1], n // (2 * h), 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    return torch.movedim(x.reshape(shape), -1, axis)


def _sqrt_size(m: int, n: int, device) -> torch.Tensor:
    """``sqrt(f32(m * n))`` as a tensor, so the division that uses it is a
    true division on every device."""
    return torch.sqrt(torch.tensor(float(m * n), dtype=torch.float32,
                                   device=device))


def hadamard_sandwich(W: torch.Tensor):
    """Orthonormal two-sided Hadamard rotation with power-of-two padding:
    ``(H1 @ W_padded @ H2 / sqrt(m2 * n2), m2, n2)``; inverted by
    :func:`hadamard_unsandwich`."""
    m, n = W.shape
    m2, n2 = 1 << (m - 1).bit_length(), 1 << (n - 1).bit_length()
    Wp = torch.nn.functional.pad(W, (0, n2 - n, 0, m2 - m))
    out = fwht(fwht(Wp, axis=0), axis=1) / _sqrt_size(m2, n2, W.device)
    return out, m2, n2


def hadamard_unsandwich(A: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Inverse of :func:`hadamard_sandwich` (the orthonormal Hadamard
    transform is an involution), cropped to ``(m, n)``."""
    out = fwht(fwht(A, axis=0), axis=1) / _sqrt_size(
        A.shape[0], A.shape[1], A.device)
    return out[:m, :n]
