"""The whole-step decode megakernel: every layer of an MHA Llama decode step
in one launch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.ops.megastep``.
:func:`megastep` launches the cooperative CUDA kernel of
``csrc/megastep.cuh`` (built as ``megastep.cu`` for 4-bit codes and
``megastep_2bit.cu`` for 2-bit ones) for CUDA tensors and runs :func:`megastep_plain`, the
same function in plain PyTorch, for CPU tensors only. Per layer it computes
RMSNorm and the per-row int8 activations, the fused q/k/v W4A8 projection
with the int8 low-rank factors (``xr = bf16(y) @ bf16(R).T * Rs``, then the
N-concatenated L), rotate-half RoPE, the int8 K/V of the current token, the
staged flash-decode attention over the head-major int8 cache (f32 dots, the
current token's dequantized K/V as one last online-softmax update), the
requantized o_proj, the MLP over the INTERLEAVED gate/up arrays
(``models.persistent.prepare_gateup_interleaved``) with the one numerics
change the reference makes on purpose: ``m = silu(gate) * up`` is staged as
bf16, its per-row scale taken on the f32 values, and ``bf16(m)`` is
requantized to int8 before the down projection.

The reference's VMEM plan (``_Plan``: chunk sizes, token and head blocks,
the TM-row padding and one-hot expansion matmuls) is the TPU's tiling and is
not ported; only its block widths ``_bn`` (the gate/up block ``bng`` is an
input layout) and its acceptance predicate are.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import _build
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

# batch rows of the reference's plan (its int8 sublane tile TM)
MAX_BATCH = 32


def _bn(bn: int, N: int) -> int:
    """The reference's block width: ``min(bn, N)`` halved until it divides
    ``N`` (``_Plan._bn``)."""
    bn = min(bn, N)
    while N % bn:
        bn //= 2
    return bn


def _block_t(T: int) -> int:
    """The reference's attention token block: all of ``T`` when ``T <= 128``
    or ``T % 128 != 0``, else 128."""
    return T if T <= 128 or T % 128 else 128


def megastep_supported(B: int, h: int, im: int, KVH: int, D: int,
                       rank: int, num_bits: int, qkv_rows: int) -> bool:
    """The reference's acceptance predicate (``_Plan.supported``): batch <=
    32, MHA (``qkv_rows``, the fused q/k/v rows, is ``3 * KVH * D``), head_dim
    and rank on 128-lane boundaries, 2- or 4-bit packing, and 128-row-aligned
    blocks of at most 256 (128 for down) with at most 128 gate/up blocks."""
    qdim = KVH * D
    bng = _bn(256, im)
    return (B <= MAX_BATCH and qkv_rows == 3 * qdim and D % 128 == 0
            and rank % 128 == 0 and num_bits in (2, 4)
            and min(_bn(256, 3 * qdim), _bn(256, h), bng, _bn(128, h)) >= 128
            and im // bng <= 128 and bng % 128 == 0)


def _check(a, kvhd) -> dict:
    """The reference's contract on the named operands ``a`` (its ``assert``
    as a ValueError) and every shape the kernel reads through raw pointers.
    Returns the dimensions."""
    KVH, D = kvhd
    B, h = a.x0.shape
    bits, rank = a.num_bits, a.rank
    f = K._pack_factor(bits)
    L, T = a.kc.shape[0], a.kc.shape[3]
    im = a.dn_packed.shape[2] * f
    qkv_rows = a.qkv_packed.shape[1]
    if not megastep_supported(B, h, im, KVH, D, rank, bits, qkv_rows):
        raise ValueError(
            f"megastep constraints violated: B={B} (at most {MAX_BATCH}), "
            f"qkv rows {qkv_rows} (MHA: 3 x {KVH} x {D}), head_dim {D} and "
            f"rank {rank} (multiples of 128), {bits}-bit (2 or 4), hidden "
            f"{h}, intermediate {im}")
    qdim = KVH * D
    want = {}
    for g, (N, Kd, nR) in (("qkv", (3 * qdim, h, 3 * rank)),
                           ("o", (h, qdim, rank)),
                           ("gu", (2 * im, h, 2 * rank)),
                           ("dn", (h, im, rank))):
        for name, shape in (("packed", (L, N, Kd // f)), ("scales", (L, N, 1)),
                            ("R", (L, nR, Kd)), ("Rs", (L, nR, 1)),
                            ("L", (L, N, rank)), ("Ls", (L, N, 1))):
            want[f"{g}_{name}"] = shape
    want.update(attn_norm=(L, h), mlp_norm=(L, h), gs_all=(L, 8), pos=(B,),
                kc=(L, B, KVH, T, D), ksc=(L, B, KVH, T),
                vc=(L, B, KVH, T, D), vsc=(L, B, KVH, T), cos=(B, D // 2),
                sin=(B, D // 2))
    bad = {k: tuple(getattr(a, k).shape) for k, s in want.items()
           if tuple(getattr(a, k).shape) != s}
    if bad:
        raise ValueError(f"shape mismatch: {bad}")
    if a.kc.dtype != torch.int8 or a.vc.dtype != torch.int8:
        raise TypeError("the K/V cache must be int8")
    for g in ("qkv", "o", "gu", "dn"):
        if (getattr(a, f"{g}_packed").dtype != torch.uint8
                or getattr(a, f"{g}_R").dtype != torch.int8
                or getattr(a, f"{g}_L").dtype != torch.int8):
            raise TypeError("packed codes must be uint8 and the R and L "
                            "factors int8 codes")
    return dict(L=L, B=B, h=h, im=im, KVH=KVH, D=D, T=T)


def _deinterleave(im: int, device) -> torch.Tensor:
    """Row ``i`` of the natural gate ++ up order sits at row ``inv[i]`` of
    the interleaved arrays (blocks ``[gate_j ++ up_j]`` of ``bng`` rows)."""
    bng = _bn(256, im)
    i = torch.arange(2 * im, device=device)
    half, r = i // im, i % im
    return (r // bng) * 2 * bng + half * bng + r % bng


# megastep's positional operands, in order
_OPERANDS = ("x0", "pos", "attn_norm", "mlp_norm",
             "qkv_packed", "qkv_scales", "qkv_R", "qkv_Rs", "qkv_L", "qkv_Ls",
             "o_packed", "o_scales", "o_R", "o_Rs", "o_L", "o_Ls",
             "gu_packed", "gu_scales", "gu_R", "gu_Rs", "gu_L", "gu_Ls",
             "dn_packed", "dn_scales", "dn_R", "dn_Rs", "dn_L", "dn_Ls",
             "gs_all", "kc", "ksc", "vc", "vsc", "cos", "sin")


def _named(args, num_bits: int, rank: int, eps: float, kvhd):
    """The checked operands of one call by name, with its dimensions."""
    a = SimpleNamespace(**dict(zip(_OPERANDS, args)), num_bits=num_bits,
                        rank=rank, eps=eps)
    a.__dict__.update(_check(a, kvhd))
    return a


def _row_scale(x: torch.Tensor) -> torch.Tensor:
    """The int8 row scale ``max(absmax, 1e-12) / 127``, divided as the
    kernel and the reference divide: by a tensor, because PyTorch multiplies
    by the reciprocal of a Python scalar divisor on the card (one f32 ulp
    off, which can flip a code on a rounding edge)."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    return amax / torch.full_like(amax, 127.0)


def _layer_plain(a, l: int, x: torch.Tensor, feed=None):
    """Layer ``l`` of :func:`megastep_plain` on the residual ``x`` (B, h):
    the layer's intermediates by name, ``x`` last. ``feed`` maps some of
    them (``qkv``, ``ao``, ``y_mlp`` with ``sy_mlp``, ``xr_gu``, ``m``) to
    values computed elsewhere, the kernel's, which then replace this
    function's own from that point on, so that one stage is held alone."""
    feed = feed or {}
    B, KVH, D, h, im, rank = a.B, a.KVH, a.D, a.h, a.im, a.rank
    qdim, bits = KVH * D, a.num_bits
    gs = a.gs_all[l].float()
    r = {}
    y = llama.rms_norm(x, a.attn_norm[l], a.eps)
    yq, sy = K.quantize_activations_int8(y, _row_scale(y))
    xr = K.thin_xr(y, a.qkv_R[l], a.qkv_Rs[l])
    qkv = K._l_from_codes(yq, sy, a.qkv_packed, a.qkv_scales, l, xr, a.qkv_L,
                          a.qkv_Ls, bits, rank, (qdim,) * 3)
    r["qkv"] = torch.cat([qkv[:, i * qdim:(i + 1) * qdim] * gs[i]
                          for i in range(3)], dim=1)
    qkv = feed.get("qkv", r["qkv"])
    c, s = a.cos.float()[:, None, :], a.sin.float()[:, None, :]
    q, k = (llama.apply_rope(qkv[:, i * qdim:(i + 1) * qdim].reshape(
        B, 1, KVH, D), c, s)[:, 0] for i in range(2))
    r["qrot"] = q.reshape(B, qdim)
    r["k8"], r["ks"] = llama.quantize_kv(k)
    r["v8"], r["vs"] = llama.quantize_kv(qkv[:, 2 * qdim:].reshape(B, KVH, D))
    ao = AT.flash_decode_q8_staged_plain(
        q[:, :, None, :], a.kc, a.vc, a.ksc, a.vsc,
        r["k8"].float() * r["ks"][..., None],
        r["v8"].float() * r["vs"][..., None], l, a.pos,
        block_t=_block_t(a.T), dots="f32").reshape(B, qdim)
    r["ao"] = ao
    ao = feed.get("ao", ao)
    aq, sa = K.quantize_activations_int8(ao, _row_scale(ao))
    xro = K.thin_xr(ao, a.o_R[l], a.o_Rs[l])
    x = x + K._l_from_codes(aq, sa, a.o_packed, a.o_scales, l, xro, a.o_L,
                            a.o_Ls, bits, rank, (h,)) * gs[3]
    y = llama.rms_norm(x, a.mlp_norm[l], a.eps)
    r["y_mlp"] = y
    y = feed.get("y_mlp", y)
    yq, sy = K.quantize_activations_int8(
        y, feed["sy_mlp"] if "sy_mlp" in feed else _row_scale(y))
    r["xr_gu"] = K.thin_xr(y, a.gu_R[l], a.gu_Rs[l])
    inv = _deinterleave(im, x.device)

    def natural(t):
        return t[l].index_select(0, inv)[None]
    gu = K._l_from_codes(yq, sy, natural(a.gu_packed), natural(a.gu_scales),
                         0, feed.get("xr_gu", r["xr_gu"]), natural(a.gu_L),
                         natural(a.gu_Ls), bits, rank, (im, im))
    g = gu[:, :im] * gs[4]
    r["m"] = m = (g * torch.sigmoid(g)) * (gu[:, im:] * gs[5])
    m = feed.get("m", m)
    r["m8"], sm = K.quantize_activations_int8(K._bf16(m), _row_scale(m))
    r["xrd"] = K.thin_xr(m, a.dn_R[l], a.dn_Rs[l])
    r["x"] = x + K._l_from_codes(r["m8"], sm, a.dn_packed, a.dn_scales, l,
                                 r["xrd"], a.dn_L, a.dn_Ls, bits, rank,
                                 (h,)) * gs[6]
    return r


def megastep_plain(x0, pos, attn_norm, mlp_norm,
                   qkv_packed, qkv_scales, qkv_R, qkv_Rs, qkv_L, qkv_Ls,
                   o_packed, o_scales, o_R, o_Rs, o_L, o_Ls,
                   gu_packed, gu_scales, gu_R, gu_Rs, gu_L, gu_Ls,
                   dn_packed, dn_scales, dn_R, dn_Rs, dn_L, dn_Ls,
                   gs_all, kc, ksc, vc, vsc, cos, sin,
                   num_bits: int, rank: int, eps: float,
                   kvhd: Tuple[int, int]):
    """Plain PyTorch version of :func:`megastep`: layer by layer, stage by
    stage in the reference kernel's order (:func:`_layer_plain`), with the
    port's plain pieces (``kernels._l_from_codes`` for the W4A8 + L tiles,
    ``kernels.thin_xr``, the staged attention's plain version). The int8
    roundings go through ``kernels.quantize_activations_int8`` and
    ``llama.quantize_kv``."""
    a = _named((x0, pos, attn_norm, mlp_norm,
                qkv_packed, qkv_scales, qkv_R, qkv_Rs, qkv_L, qkv_Ls,
                o_packed, o_scales, o_R, o_Rs, o_L, o_Ls,
                gu_packed, gu_scales, gu_R, gu_Rs, gu_L, gu_Ls,
                dn_packed, dn_scales, dn_R, dn_Rs, dn_L, dn_Ls,
                gs_all, kc, ksc, vc, vsc, cos, sin), num_bits, rank, eps,
               kvhd)
    x, staged = x0.float(), []
    for l in range(a.L):
        r = _layer_plain(a, l, x)
        staged.append((r["k8"], r["ks"], r["v8"], r["vs"]))
        x = r["x"]
    k8, ks8, v8, vs8 = (torch.stack(t) for t in zip(*staged))
    return x, k8, ks8, v8, vs8


# The C struct MegaArgs of csrc/megastep.cuh, field for field.
_PTRS = ("x0", "pos", "cos", "sin", "an", "mn", "gs",
         "q_w", "q_s", "q_R", "q_Rs", "q_L", "q_Ls",
         "o_w", "o_s", "o_R", "o_Rs", "o_L", "o_Ls",
         "g_w", "g_s", "g_R", "g_Rs", "g_L", "g_Ls",
         "d_w", "d_s", "d_R", "d_Rs", "d_L", "d_Ls",
         "kc", "vc", "kcs", "vcs",
         "x", "k8", "ks8", "v8", "vs8",
         "y", "a8", "sy", "xr", "xrd", "qkv", "qrot", "kf", "vf", "ao",
         "part", "m", "pws", "cnt", "ylr")
_INTS = ("L", "B", "h", "im", "KVH", "D", "T", "bt", "rank", "bng")

# The projection stages' plan (csrc/megastep_proj.cuh): packed bytes of a
# weight row per slab, rows of a tile, warps of a CTA.
_KC, _TILE_ROWS, _WARPS = 128, 16, 8


def _stage_plan(h: int, im: int, qdim: int, num_bits: int, bng: int):
    """The four projection stages as the kernel cuts them (``Plan.st``):
    ``(P, nk, groups, nrows, bng)`` each: packed bytes of a row, chunks of
    128 bytes a row, groups of two 16-row tiles (32 consecutive rows, or for
    gate/up 16 gate rows and the same up rows), rows a layer."""
    f = K._pack_factor(num_bits)

    def stage(kd, groups, nrows, b=0):
        P = kd // f
        return (P, -(-P // _KC), groups, nrows, b)
    return (stage(h, 3 * qdim // 32, 3 * qdim), stage(qdim, h // 32, h),
            stage(h, im // _TILE_ROWS, 2 * im, bng), stage(im, h // 32, h))


def _group_rows(g: int, bng: int):
    """The first rows of group ``g``'s two 16-row tiles (``group_rows``)."""
    if bng == 0:
        return 32 * g, 32 * g + _TILE_ROWS
    i0 = _TILE_ROWS * g
    r0 = 2 * (i0 // bng) * bng + i0 % bng
    return r0, r0 + bng


def _warp_range(S: int, w: int, W: int):
    """Warp ``w``'s slabs ``[lo, hi)`` of a stage's ``S`` cut ``W`` ways."""
    return S * w // W, S * (w + 1) // W


def _owner(s: int, S: int, W: int) -> int:
    """The warp whose range holds slab ``s``."""
    return ((s + 1) * W - 1) // S


def _contributors(g: int, nk: int, S: int, W: int):
    """The warps whose slabs make up group ``g`` (``split_sum``'s walk: the
    owner of the group's first slab, then the owner of the slab after each
    one's range)."""
    out, s = [], g * nk
    while s < (g + 1) * nk:
        out.append(_owner(s, S, W))
        s = _warp_range(S, out[-1] + 1, W)[0]
    return out


def _counters(h: int, im: int, qdim: int) -> int:
    """Split-group counters: the most groups of any stage."""
    return max(3 * qdim // 32, h // 32, im // _TILE_ROWS)


class _MegaArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS]
                + [("eps", ctypes.c_float), ("scale", ctypes.c_float)])


def _scratch(B: int, h: int, im: int, qdim: int, KVH: int, rank: int,
             ctas: int, device):
    """One byte buffer holding the kernel's scratch, and a typed view of
    each region (256-byte aligned offsets). The absmax partials take (KVH,
    B) slots, then (im / 16, B) (one per gate/up group); the split-group
    partials two slots of 32 x MT i32 for each warp of the ``ctas`` CTAs (MT
    = 8 at B <= 8, else 32), the counters one i32 per group and a flag per
    warp (zeroed by the kernel), the L dots of a stage's rows (rows, B)."""
    f4, i1, i4 = torch.float32, torch.int8, torch.int32
    mt = 8 if B <= 8 else 32
    shapes = dict(y=((B, h), f4), a8=((B * max(h, qdim, im),), i1),
                  sy=((B,), f4), xr=((B * 3 * rank,), f4), xrd=((B, rank), f4),
                  qkv=((B, 3 * qdim), f4), qrot=((B, qdim), f4),
                  kf=((B, qdim), f4), vf=((B, qdim), f4), ao=((B, qdim), f4),
                  part=((max(KVH, im // _TILE_ROWS) * B,), f4),
                  m=((B, im), f4),
                  pws=((ctas * _WARPS * 2 * 32 * mt,), i4),
                  cnt=((_counters(h, im, qdim) + ctas * _WARPS,), i4),
                  ylr=((max(3 * qdim, h, 2 * im) * B,), f4))
    offs, n = {}, 0
    for k, (shape, dt) in shapes.items():
        offs[k] = n
        nbytes = torch.Size(shape).numel() * (1 if dt == i1 else 4)
        n += (nbytes + 255) // 256 * 256
    buf = torch.empty(n, dtype=torch.uint8, device=device)
    return {k: buf[offs[k]:offs[k] + torch.Size(shape).numel() * (
        1 if dt == i1 else 4)].view(dt).view(shape)
        for k, (shape, dt) in shapes.items()}


def _launch(a, grid_only: bool = False):
    """Fill :class:`_MegaArgs` from the named, checked operands ``a``
    (:func:`_named`) and launch ``megastep_launch`` (or, with
    ``grid_only``, return the CTAs of the cooperative grid). Returns
    ``((x_out, k8, ks8, v8, vs8), scratch)``: the scratch views hold the
    last layer's intermediates."""
    L, B, h, im, KVH, D = a.L, a.B, a.h, a.im, a.KVH, a.D
    if D > 128:
        raise ValueError(f"the CUDA kernel takes head_dim up to 128 (its "
                         f"attention's shared memory), got {D}")
    dev = a.x0.device
    # pointer fields of _MegaArgs -> the operands they take
    f32 = dict(x0=a.x0, cos=a.cos, sin=a.sin, an=a.attn_norm, mn=a.mlp_norm,
               gs=a.gs_all, kcs=a.ksc, vcs=a.vsc)
    raw = dict(kc=a.kc, vc=a.vc)
    for group, prefix in (("qkv", "q"), ("o", "o"), ("gu", "g"), ("dn", "d")):
        for i, name in enumerate(("packed", "scales", "R", "Rs", "L", "Ls")):
            t = getattr(a, f"{group}_{name}")
            field = f"{prefix}_{('w', 's', 'R', 'Rs', 'L', 'Ls')[i]}"
            (raw if i in (0, 2, 4) else f32)[field] = t
        if raw[f"{prefix}_w"].data_ptr() % 16:
            raise ValueError("packed codes must be 16-byte aligned")
    ops = {k: t.float().contiguous() for k, t in f32.items()}
    ops.update(raw, pos=a.pos.to(torch.int32).contiguous())
    for t in ops.values():
        if t.device != dev or not t.is_contiguous():
            raise ValueError("megastep operands must be contiguous and on one "
                             "device")
    out = dict(x=torch.empty((B, h), dtype=torch.float32, device=dev),
               k8=torch.empty((L, B, KVH, D), dtype=torch.int8, device=dev),
               ks8=torch.empty((L, B, KVH), dtype=torch.float32, device=dev),
               v8=torch.empty((L, B, KVH, D), dtype=torch.int8, device=dev),
               vs8=torch.empty((L, B, KVH), dtype=torch.float32, device=dev))
    args = _MegaArgs(**{k: t.data_ptr() for d in (ops, out)
                        for k, t in d.items()},
                     L=L, B=B, h=h, im=im, KVH=KVH, D=D, T=a.T,
                     bt=_block_t(a.T), rank=a.rank, bng=_bn(256, im),
                     eps=float(a.eps), scale=AT._scale_f32(D))
    lib = _build.library("megastep" if a.num_bits == 4 else "megastep_2bit")
    size = lib.megastep_args_size()
    if size != ctypes.sizeof(_MegaArgs):
        raise RuntimeError(f"MegaArgs is {size} bytes in csrc/megastep.cuh "
                           f"but {ctypes.sizeof(_MegaArgs)} in _MegaArgs")
    ctas = ctypes.c_int(0)
    _build.check(lib.megastep_grid(ctypes.byref(args), ctypes.byref(ctas)),
                 "megastep_grid")
    if grid_only:
        return ctas.value
    scratch = _scratch(B, h, im, KVH * D, KVH, a.rank, ctas.value, dev)
    for k, t in scratch.items():
        setattr(args, k, t.data_ptr())
    err = lib.megastep_launch(ctypes.byref(args), _build.stream_ptr(dev))
    _build.check(err, "megastep")
    return tuple(out.values()), scratch


def megastep(x0, pos, attn_norm, mlp_norm,
             qkv_packed, qkv_scales, qkv_R, qkv_Rs, qkv_L, qkv_Ls,
             o_packed, o_scales, o_R, o_Rs, o_L, o_Ls,
             gu_packed, gu_scales, gu_R, gu_Rs, gu_L, gu_Ls,
             dn_packed, dn_scales, dn_R, dn_Rs, dn_L, dn_Ls,
             gs_all, kc, ksc, vc, vsc, cos, sin,
             num_bits: int, rank: int, eps: float, kvhd: Tuple[int, int]):
    """Run every layer of the decode stack as ONE kernel launch.

    Arrays as stacked by :mod:`models.fused` on factor path "l" (int8 ``R``
    with (L, r, 1) row scales, N-concatenated int8 ``L`` with (L, N, 1)
    scales, packed codes with (L, N, 1) row scales), EXCEPT the gate/up
    family (``gu_packed``/``gu_scales``/``gu_L``/``gu_Ls``), which must be
    INTERLEAVED by ``bng``-row blocks (``[gate_j ++ up_j]``, see
    ``models.persistent.prepare_gateup_interleaved``; build it once at load,
    the packed array is GB-scale). ``gs_all`` is (L, 8) f32 global scales
    ``[q, k, v, o, gate, up, down, 0]``; ``cos``/``sin`` the (B, D/2) RoPE
    tables of the CURRENT positions; ``kc``/``ksc``/``vc``/``vsc`` the
    head-major int8 cache, which must hold tokens ``< pos`` only.

    Returns ``(x_out (B, h) f32, k8 (L, B, KVH, D) int8, ks (L, B, KVH)
    f32, v8, vs)``: the final hidden state before the final norm, and this
    step's K/V for the caller's end-of-step commit. CUDA tensors launch the
    cooperative kernel of ``csrc/megastep.cuh``; CPU tensors run
    :func:`megastep_plain`. Raises ValueError where the reference asserts
    (:func:`megastep_supported`).
    """
    args = (x0, pos, attn_norm, mlp_norm,
            qkv_packed, qkv_scales, qkv_R, qkv_Rs, qkv_L, qkv_Ls,
            o_packed, o_scales, o_R, o_Rs, o_L, o_Ls,
            gu_packed, gu_scales, gu_R, gu_Rs, gu_L, gu_Ls,
            dn_packed, dn_scales, dn_R, dn_Rs, dn_L, dn_Ls,
            gs_all, kc, ksc, vc, vsc, cos, sin)
    if x0.device.type == "cpu":
        return megastep_plain(*args, num_bits, rank, eps, kvhd)
    out, _ = _launch(_named(args, num_bits, rank, eps, kvhd))
    megastep.launches += 1
    return out


megastep.launches = 0


def _proj_sums(x8: torch.Tensor, packed: torch.Tensor, num_bits: int,
               bng: int = 0, ctas: int = None) -> torch.Tensor:
    """One projection stage of the kernel alone (``megastep_proj_launch``,
    card tests): the exact i32 sums ``sum_k (code(packed[n, k]) - maxq) *
    x8[m, k]`` as an (N, B) int32 tensor, through the kernel's stream, split
    plan over ``ctas`` CTAs (default: one per SM) and group layout (``bng``
    0: 32 consecutive rows a group; else gate/up blocks of ``bng`` rows).
    The counters must come back zeroed, which the call checks."""
    B, Kd = x8.shape
    N = packed.shape[0]
    dev = x8.device
    if ctas is None:
        ctas = torch.cuda.get_device_properties(dev).multi_processor_count
    mt = 8 if B <= 8 else 32
    groups = N // (2 * _TILE_ROWS) if bng else N // 32
    out = torch.empty((N, B), dtype=torch.int32, device=dev)
    pws = torch.empty((ctas * _WARPS * 2 * 32 * mt,), dtype=torch.int32,
                      device=dev)
    cnt = torch.zeros((max(groups, 1),), dtype=torch.int32, device=dev)
    lib = _build.library("megastep" if num_bits == 4 else "megastep_2bit")
    _build.check(lib.megastep_proj_launch(
        x8.contiguous().data_ptr(), packed.contiguous().data_ptr(),
        out.data_ptr(), pws.data_ptr(), cnt.data_ptr(), N, Kd, B, bng, ctas,
        _build.stream_ptr(dev)), "megastep_proj_launch")
    if int(cnt.abs().sum()):
        raise RuntimeError("megastep_proj_launch left a split counter set")
    return out


def megastep_ctas(*args, num_bits: int, rank: int, eps: float,
                  kvhd: Tuple[int, int]) -> int:
    """The CTAs of the cooperative grid that :func:`megastep` launches for
    these (CUDA) operands: the occupancy query times the SMs."""
    return _launch(_named(args, num_bits, rank, eps, kvhd), grid_only=True)
