"""Fused-projection W4A8 prefill and decode steps, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.fused``
for the serving path: q/k/v and gate/up concatenate along the output
dimension so each layer makes four W4A8 matmul launches (qkv, o, gate+up,
down) and one attention launch, all hand-written CUDA kernels on the card
(flash prefill for a prompt; staged, inline or all-batch flash decode for a
step over the head-major int8 cache); the int8 lm_head adds one int8 matmul
launch per call. Activation quantization, RMSNorm, RoPE, KV quantization,
SiLU, the low-rank factor dots and the attention over the token-major
caches stay plain PyTorch, as the reference leaves them to XLA.

Fusion keeps the math of the unfused projections: packed codes, row scales
and biases concatenate along N; the ``R`` factors concatenate along the rank
axis (one ``(B, sum_ranks)`` dot) while the ``L`` factors stay per
projection; each projection's ``global_scale`` applies to its output slice.

The reference's options run on more kernels: factor path "l" adds the L
half of the factors inside the W4A8 kernel (the L-fused kernel over the
N-concatenated ``L_cat``; o and down as groups of one), "lr" both halves
(qkv and gate/up); ``mlp_kernel`` makes gate/up, SiLU, the requantization
and down one launch, ``attn_o_kernel`` fuses the decode attention with
o_proj; ``proj_kernel="persistent"`` runs o and down on the persistent
launch of the W4A8 kernel; ``attn_dots`` picks the decode kernels' dot
mode ("f32", "bf16" or "i8").

Under ``tp_axis`` (a ``torch.distributed`` group; ``parallel.tp_fused``) a
step runs on the rank's shard, as the reference's does inside
``shard_map``: qkv and gate/up column-parallel, o and down row-parallel,
their activations quantized with the group's global row absmax (one
``all_reduce`` MAX), the K-partial ``xr`` of their factor dots summed
before its bf16 cast and kept on rank 0 only, and one ``all_reduce`` SUM of
each output; the logits are the rank's vocabulary shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear, quantize_factors_int8, quantize_linear_int8)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    HeadMajorQuantKVCache, KVCache, QuantKVCache)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.stacked import (
    StackedModelParams, _apply_w4a8)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import comm


@dataclasses.dataclass
class FusedW4A8Linear:
    """Several same-input w4a8 :class:`CalderaLinear` projections fused
    along the output dimension (all tensors layer-stacked)."""

    packed: torch.Tensor               # (layers, sum_N, K/f) uint8
    scales: torch.Tensor               # (layers, sum_N, 1) f32
    R: torch.Tensor                    # (layers, sum_ranks, K) bf16 | int8
    Ls: Tuple[torch.Tensor, ...]       # per-projection (layers, N_i, r_i)
    global_scale: torch.Tensor         # (layers, n_proj) f32
    b: Optional[torch.Tensor] = None   # (layers, sum_N) or None
    R_scale: Optional[torch.Tensor] = None                # (layers, sum_r, 1)
    L_scales: Optional[Tuple[torch.Tensor, ...]] = None   # (layers, N_i, 1)
    # N-concatenated int8 L factors of the fused-factor kernels (factor
    # paths "l"/"lr"); when set, ``Ls`` is empty (one storage copy)
    L_cat: Optional[torch.Tensor] = None                  # (layers, sum_N, r)
    L_scale_cat: Optional[torch.Tensor] = None            # (layers, sum_N, 1)
    num_bits: int = 4
    splits: Tuple[int, ...] = ()
    ranks: Tuple[int, ...] = ()
    # "xla": factor dots outside the packed kernel; "l": the L half inside
    # it (xr a torch dot); "lr": both halves inside it
    factor_kernel: str = "xla"


@dataclasses.dataclass
class FusedLayerStack:
    attn_norm: torch.Tensor            # (layers, hidden)
    qkv: FusedW4A8Linear
    o_proj: CalderaLinear              # stacked w4a8
    mlp_norm: torch.Tensor
    gateup: FusedW4A8Linear
    down_proj: CalderaLinear           # stacked w4a8


@dataclasses.dataclass
class FusedStackedParams:
    embed: torch.Tensor
    layers: FusedLayerStack
    final_norm: torch.Tensor
    lm_head: Optional[object]


def _fuse_group(lins) -> FusedW4A8Linear:
    """Fuse stacked w4a8 CalderaLinears sharing the same input."""
    for lin in lins:
        if not isinstance(lin, CalderaLinear) or lin.mode != "w4a8":
            raise ValueError("fused path requires w4a8 CalderaLinear "
                             f"projections, got {type(lin).__name__} "
                             f"mode={getattr(lin, 'mode', None)}")
    bits = {lin.num_bits for lin in lins}
    if len(bits) != 1:
        raise ValueError(f"fused projections must share num_bits, got {bits}")
    packed = torch.cat([lin.packed for lin in lins], dim=1)
    scales = torch.cat([lin.scales for lin in lins], dim=1)
    facs = [lin.factors() for lin in lins]
    R = torch.cat([R_i for _, R_i in facs], dim=1).to(torch.bfloat16)
    Ls = tuple(L_i.to(torch.bfloat16) for L_i, _ in facs)
    gs = torch.stack([lin.global_scale.reshape(-1) for lin in lins], dim=1)
    if any(lin.b is not None for lin in lins):
        b = torch.cat(
            [lin.b if lin.b is not None
             else torch.zeros(lin.packed.shape[:2], dtype=torch.float32,
                              device=lin.packed.device)
             for lin in lins], dim=1)
    else:
        b = None
    return FusedW4A8Linear(
        packed=packed, scales=scales, R=R, Ls=Ls, global_scale=gs, b=b,
        num_bits=lins[0].num_bits,
        splits=tuple(lin.packed.shape[1] for lin in lins),
        ranks=tuple(lin.R.shape[1] for lin in lins))


def fuse_stacked(params: StackedModelParams) -> FusedStackedParams:
    """Convert stacked w4a8 params to the fused-projection layout."""
    lp = params.layers
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        lin = getattr(lp, name)
        if not isinstance(lin, CalderaLinear) or lin.mode != "w4a8":
            raise ValueError(f"{name} must be a stacked w4a8 CalderaLinear")
    layers = FusedLayerStack(
        attn_norm=lp.attn_norm,
        qkv=_fuse_group([lp.q_proj, lp.k_proj, lp.v_proj]),
        o_proj=lp.o_proj,
        mlp_norm=lp.mlp_norm,
        gateup=_fuse_group([lp.gate_proj, lp.up_proj]),
        down_proj=lp.down_proj)
    return FusedStackedParams(embed=params.embed, layers=layers,
                              final_norm=params.final_norm,
                              lm_head=params.lm_head)


def _quantize_fused_factors(fp: FusedW4A8Linear,
                            factor_kernel: str = "xla") -> FusedW4A8Linear:
    if fp.R_scale is not None:
        return fp
    R8, Rs = K.quantize_int8_rowwise(fp.R)
    pairs = [K.quantize_int8_rowwise(L) for L in fp.Ls]
    if (factor_kernel in ("l", "lr")
            and K.lr_stacked_supported(fp.splits, fp.ranks,
                                       num_bits=fp.num_bits)):
        # one storage copy: the N-concatenated codes of the fused-factor
        # kernels; the per-projection scales are kept (small)
        return dataclasses.replace(
            fp, R=R8, R_scale=Rs, Ls=(),
            L_scales=tuple(s for _, s in pairs),
            L_cat=torch.cat([c for c, _ in pairs], dim=1),
            L_scale_cat=torch.cat([s for _, s in pairs], dim=1),
            factor_kernel=factor_kernel)
    return dataclasses.replace(
        fp, R=R8, R_scale=Rs, Ls=tuple(c for c, _ in pairs),
        L_scales=tuple(s for _, s in pairs))


def quantize_factors_int8_fused(params: FusedStackedParams,
                                lm_head_int8: bool = True,
                                fuse_factor_kernel=False
                                ) -> FusedStackedParams:
    """int8-quantize all low-rank factors (and optionally the lm_head, or
    the tied embedding as a head) of a fused model.

    ``fuse_factor_kernel`` picks the factor path of the steps:

    - False / ``"xla"``: the factor dots outside the packed kernel;
    - ``"l"``: the L half inside the packed kernel
      (:func:`ops.kernels.quantized_matmul_w4a8_l_stacked` over the
      N-concatenated ``L_cat``), the thin ``xr = x @ R.T`` a torch dot; o
      and down take the same kernel as groups of one;
    - True / ``"lr"``: both halves inside the kernel
      (:func:`ops.kernels.quantized_matmul_w4a8_lr_stacked`) for qkv and
      gate/up; o and down keep the "xla" path.

    As in the reference, a group that
    :func:`ops.kernels.lr_stacked_supported` rejects keeps the per-projection
    layout and the "xla" path.
    """
    fk = {False: "xla", True: "lr"}.get(fuse_factor_kernel,
                                        fuse_factor_kernel)
    if fk not in ("xla", "l", "lr"):
        raise ValueError(f"unknown factor kernel {fuse_factor_kernel!r}")
    lp = params.layers
    layers = FusedLayerStack(
        attn_norm=lp.attn_norm,
        qkv=_quantize_fused_factors(lp.qkv, fk),
        o_proj=quantize_factors_int8(lp.o_proj),
        mlp_norm=lp.mlp_norm,
        gateup=_quantize_fused_factors(lp.gateup, fk),
        down_proj=quantize_factors_int8(lp.down_proj))
    lm_head = params.lm_head
    if lm_head_int8:
        if lm_head is None:
            lm_head = quantize_linear_int8(DenseLinear(w=params.embed))
        elif isinstance(lm_head, DenseLinear):
            lm_head = quantize_linear_int8(lm_head)
    return FusedStackedParams(embed=params.embed, layers=layers,
                              final_norm=params.final_norm, lm_head=lm_head)


def _split_outputs(fp: FusedW4A8Linear, l: int, out_cat: torch.Tensor):
    """Per-projection global scales and biases on the fused output."""
    gs_l = fp.global_scale[l]
    b_l = None if fp.b is None else fp.b[l]
    outs, off_n = [], 0
    for i, N_i in enumerate(fp.splits):
        out = out_cat[:, off_n:off_n + N_i] * gs_l[i]
        if b_l is not None:
            out = out + b_l[off_n:off_n + N_i][None, :]
        outs.append(out)
        off_n += N_i
    return tuple(outs)


def _apply_fused(fp: FusedW4A8Linear, l: int, y: torch.Tensor):
    """One W4A8 launch (the fused-factor kernels under ``L_cat``) +
    per-projection low-rank adds; returns a tuple of (B, N_i) outputs in
    fusion order."""
    if fp.L_cat is not None:
        if fp.factor_kernel == "l":
            xr = K.thin_xr(y, fp.R[l], fp.R_scale[l])
            out_cat = K.quantized_matmul_w4a8_l_stacked(
                y, fp.packed, fp.scales, l, xr, fp.L_cat, fp.L_scale_cat,
                num_bits=fp.num_bits, rank=fp.ranks[0], splits=fp.splits)
        else:
            out_cat = K.quantized_matmul_w4a8_lr_stacked(
                y, fp.packed, fp.scales, l, fp.R, fp.R_scale, fp.L_cat,
                fp.L_scale_cat, num_bits=fp.num_bits, rank=fp.ranks[0],
                splits=fp.splits)
        return _split_outputs(fp, l, out_cat)
    yq = K.quantized_matmul_w4a8_stacked(y, fp.packed, fp.scales, l,
                                         fp.num_bits)
    xr = y.to(torch.bfloat16).float() @ fp.R[l].to(torch.bfloat16).float().T
    if fp.R_scale is not None:
        xr = xr * fp.R_scale[l][:, 0][None, :]
    ylrs, off_r = [], 0
    for i, r_i in enumerate(fp.ranks):
        ylr = (xr[:, off_r:off_r + r_i].to(torch.bfloat16).float()
               @ fp.Ls[i][l].to(torch.bfloat16).float().T)
        if fp.L_scales is not None:
            ylr = ylr * fp.L_scales[i][l][:, 0][None, :]
        ylrs.append(ylr)
        off_r += r_i
    return _split_outputs(fp, l, yq + torch.cat(ylrs, dim=1))


def _apply_plain(lin: CalderaLinear, l: int, y: torch.Tensor,
                 factor_kernel: str = "xla",
                 proj_kernel: str = "grid", tp_axis=None) -> torch.Tensor:
    """Layer ``l`` of a single stacked w4a8 projection on ``y`` (..., in).
    ``factor_kernel="l"`` with int8 factors adds the L half inside the
    packed kernel (a group of one; ``xr`` a torch dot) and ignores
    ``proj_kernel``, as the reference does; otherwise one stacked W4A8
    launch (on the persistent grid when ``proj_kernel="persistent"``) plus
    the torch factor dots. Global scale and bias applied.

    ``tp_axis`` (``y`` the rank's K-shard of a row-parallel input): the int8
    activation scale is the group's global row absmax / 127 (one
    ``all_reduce`` MAX), so every rank quantizes as the single-device step
    does, and the factor dots' ``xr`` is summed over the group before its
    bf16 cast and kept on rank 0 only, so that the caller's sum of the
    outputs (:func:`_tp_sum`) counts it once."""
    act_scale = xr_reduce = None
    if tp_axis is not None:
        absmax = y.reshape(-1, y.shape[-1]).float().abs().amax(
            dim=1, keepdim=True).clamp_min(1e-12)
        act_scale = comm.all_max(absmax, tp_axis) / 127.0

        def xr_reduce(xr):
            xr = comm.all_sum(xr, tp_axis)
            return xr if comm.group_rank(tp_axis) == 0 else \
                torch.zeros_like(xr)

    if factor_kernel != "l" or lin.L_scale is None:
        return _apply_w4a8(lin, l, y, proj_kernel == "persistent",
                           act_scale, xr_reduce)
    y2 = y.reshape(-1, y.shape[-1])
    xr = K.thin_xr(y2, lin.R[l], lin.R_scale[l])
    if xr_reduce is not None:
        xr = xr_reduce(xr)
    out = K.quantized_matmul_w4a8_l_stacked(
        y2, lin.packed, lin.scales, l, xr, lin.L, lin.L_scale,
        num_bits=lin.num_bits, rank=lin.L.shape[2],
        splits=(lin.packed.shape[1],), act_scale=act_scale)
    out = out * lin.global_scale[l]
    if lin.b is not None:
        out = out + lin.b[l][None, :]
    return out.reshape(*y.shape[:-1], out.shape[-1])


def _mlp_kernel_supported(params: FusedStackedParams) -> bool:
    """Whether the whole-MLP kernel can serve this model: fused gate/up with
    N-concatenated int8 L factors (factor path "l"/"lr"), int8 down_proj
    factors, one rank on 128-lane boundaries, no MLP biases."""
    gu = params.layers.gateup
    dn = params.layers.down_proj
    return (gu.L_cat is not None and gu.b is None
            and isinstance(dn, CalderaLinear) and dn.b is None
            and dn.L_scale is not None and dn.R_scale is not None
            and gu.num_bits == dn.num_bits
            and len(set(gu.ranks)) == 1
            and dn.L.shape[2] == gu.ranks[0]
            and K.mlp_stacked_supported(
                gu.splits[0], dn.packed.shape[1], gu.ranks[0], gu.num_bits))


def _apply_mlp_mega(lp: FusedLayerStack, l: int,
                    y: torch.Tensor) -> torch.Tensor:
    """``down(silu(gate(y)) * up(y))`` in one kernel launch (the thin
    gate/up ``xr`` a torch dot), times down's global scale: the residual
    add's term."""
    gu, dn = lp.gateup, lp.down_proj
    xr = K.thin_xr(y, gu.R[l], gu.R_scale[l])
    out = K.quantized_matmul_w4a8_mlp_stacked(
        y, gu.packed, gu.scales, l, xr, gu.L_cat, gu.L_scale_cat,
        gu.global_scale, dn.packed, dn.scales, dn.R, dn.R_scale, dn.L,
        dn.L_scale, num_bits=gu.num_bits, rank=gu.ranks[0])
    return out * dn.global_scale[l]


def _attn_o_kernel_supported(params: FusedStackedParams,
                             config: ModelConfig) -> bool:
    """Whether the fused attention + o_proj kernel can serve this model:
    MHA, an int8-factor w4a8 o_proj with its rank on 128-lane boundaries,
    no o bias."""
    o = params.layers.o_proj
    return (isinstance(o, CalderaLinear) and o.mode == "w4a8"
            and o.b is None and o.L_scale is not None
            and o.R_scale is not None
            and AT.attn_o_supported(
                config.num_kv_heads,
                config.num_heads // config.num_kv_heads,
                config.head_dim, o.packed.shape[1], o.L.shape[2]))


def _tp_sum(v: torch.Tensor, tp_axis) -> torch.Tensor:
    """Complete a row-parallel partial product under tensor parallelism (a
    no-op on one device)."""
    return v if tp_axis is None else comm.all_sum(v, tp_axis)


def _check_tp(params: FusedStackedParams, tp_axis) -> None:
    """A row-parallel bias would be added on every rank of the group."""
    if tp_axis is not None and (params.layers.o_proj.b is not None
                                or params.layers.down_proj.b is not None):
        raise ValueError("row-parallel o/down projections cannot carry a "
                         "bias under tensor parallelism")


def _check_cache(cache):
    if not isinstance(cache, (HeadMajorQuantKVCache, QuantKVCache, KVCache)):
        raise TypeError(f"unknown cache type {type(cache).__name__}")


def _qkv(lp: FusedLayerStack, l: int, x: torch.Tensor, cos, sin,
         config: ModelConfig, lead: Tuple[int, int]):
    """RMSNorm, the fused qkv projection and RoPE for the rows ``x``
    (N, h); q/k/v come back as (*lead, heads, head_dim)."""
    y = llama.rms_norm(x, lp.attn_norm[l], config.rms_norm_eps)
    q, k, v = _apply_fused(lp.qkv, l, y)
    D = config.head_dim
    q = llama.apply_rope(q.reshape(*lead, config.num_heads, D), cos, sin)
    k = llama.apply_rope(k.reshape(*lead, config.num_kv_heads, D), cos, sin)
    return q, k, v.reshape(*lead, config.num_kv_heads, D)


def _mlp(lp: FusedLayerStack, l: int, x: torch.Tensor, config: ModelConfig,
         mlp_kernel: bool = False, proj_kernel: str = "grid",
         tp_axis=None) -> torch.Tensor:
    """RMSNorm, gate/up, SiLU and the down residual; ``mlp_kernel`` runs
    them as one whole-MLP kernel launch."""
    y = llama.rms_norm(x, lp.mlp_norm[l], config.rms_norm_eps)
    if mlp_kernel:
        return x + _apply_mlp_mega(lp, l, y)
    gate, up = _apply_fused(lp.gateup, l, y)
    return x + _tp_sum(_apply_plain(
        lp.down_proj, l, gate * torch.sigmoid(gate) * up,
        lp.qkv.factor_kernel, proj_kernel, tp_axis), tp_axis)


def _mlp_and_o(lp: FusedLayerStack, l: int, x: torch.Tensor,
               attn: torch.Tensor, config: ModelConfig,
               proj_kernel: str = "grid", tp_axis=None) -> torch.Tensor:
    """The rest of a layer: o_proj residual, RMSNorm, gate/up, SiLU, down
    residual (o and down on the qkv group's factor path, as the
    reference)."""
    x = x + _tp_sum(_apply_plain(lp.o_proj, l, attn, lp.qkv.factor_kernel,
                                 proj_kernel, tp_axis), tp_axis)
    return _mlp(lp, l, x, config, proj_kernel=proj_kernel, tp_axis=tp_axis)


def _attn_o(o: CalderaLinear, l: int, qh, cache: HeadMajorQuantKVCache, kf,
            vf, pos) -> torch.Tensor:
    """Attention over layer ``l`` fused with the o_proj (staged when the
    current token's ``kf``/``vf`` are given): the (B, h) o_proj output
    before its global scale."""
    return AT.flash_decode_attn_o(
        qh, cache.k, cache.v, cache.k_scale, cache.v_scale, kf, vf, l, pos,
        o.packed, o.scales, o.R, o.R_scale, o.L, o.L_scale,
        num_bits=o.num_bits, rank=o.L.shape[2], staged=kf is not None)


def _commit(cache: HeadMajorQuantKVCache, staging, pos: torch.Tensor,
            row0: int = 0):
    """Write each row's staged K/V (all layers) at column ``pos[b]`` of
    cache row ``row0 + b``, in place: one indexed write per cache tensor.
    Positions past the end clamp to the last column, as the reference's
    dynamic_update_slice does."""
    sk, sks, sv, svs = staging                 # (L, B, KVH[, D])
    T = cache.k.shape[3]
    rows = row0 + torch.arange(pos.shape[0], device=pos.device)
    col = pos.long().clamp(0, T - 1)
    # advanced indices on dims 1 and 3 move to the front: (B, L, KVH[, D])
    cache.k[:, rows, :, col] = sk.transpose(0, 1)
    cache.v[:, rows, :, col] = sv.transpose(0, 1)
    cache.k_scale[:, rows, :, col] = sks.transpose(0, 1)
    cache.v_scale[:, rows, :, col] = svs.transpose(0, 1)


def _last_logits(params: FusedStackedParams, x: torch.Tensor, last_pos,
                 config: ModelConfig) -> torch.Tensor:
    """Logits (vocab,) of row ``last_pos`` of ``x`` (see
    ``llama._last_row``)."""
    return llama._head(params, llama._last_row(x, last_pos), config)[0]


def decode_step_fused(params: FusedStackedParams, tokens: torch.Tensor,
                      pos: torch.Tensor, cache, config: ModelConfig,
                      staged_kv=False, mlp_kernel: bool = False,
                      attn_o_kernel: bool = False,
                      attn_dots: str = "f32",
                      head_pallas: bool = False,
                      attn_kernel: str = "row",
                      tp_axis=None,
                      proj_kernel: str = "grid"):
    """Batched decode step on the fused-projection W4A8 path.

    ``tokens`` (B,) int and ``pos`` (B,) int32 on the params' device; the
    step computes on that device. Returns ``(logits (B, vocab) f32,
    cache)``; the cache tensors are **updated in place** (the reference
    donates them). ``cache`` is a :class:`HeadMajorQuantKVCache` (flash
    attention kernels), a token-major int8 :class:`QuantKVCache` or a bf16
    :class:`KVCache` (plain attention, as the reference's XLA path).

    ``staged_kv`` (head-major cache only): False writes each layer's K/V
    at column ``pos[b]`` before the inline attention (tokens ``<= pos``);
    True or "uniform" stage them, attend the cache's tokens ``< pos`` plus
    the staged token, and commit once at the end. The reference's
    "uniform" commit writes column ``pos[0]`` for every row and falls back
    to per-row writes for ragged positions; here both modes take the
    per-row indexed write, so ragged positions stay correct by
    construction. ``attn_kernel``: "row" or "ab" (the all-batch kernel's
    block partition; head-major only). ``attn_dots``: "i8", "bf16" or
    "f32" (the decode kernels' dots over the cache blocks).
    ``mlp_kernel``: the whole MLP as one kernel launch per layer (params
    quantized with factor path "l" or "lr"). ``attn_o_kernel``: attention
    fused with o_proj in one kernel launch per layer (head-major cache, MHA,
    ``attn_dots="f32"``, row grid). ``proj_kernel``: "grid" or
    "persistent", the launch of the o and down projections' W4A8 kernel
    where they take it (not inside ``attn_o_kernel`` or ``mlp_kernel``, not
    on factor path "l"); the output is the same bit for bit. ``head_pallas``
    is accepted and has no effect: the int8 head always runs the int8 matmul
    kernel on the card and its plain version on the CPU. ``tp_axis``: a
    ``torch.distributed`` group; ``params``, ``cache`` and ``config`` are the
    rank's shard (``parallel.tp_fused``), o and down row-parallel (see the
    module docstring), and the logits the rank's vocabulary shard; the
    attention + o_proj and whole-MLP kernels and row-parallel biases are
    refused, as the reference refuses them.
    """
    if attn_kernel not in ("row", "ab"):
        raise ValueError(f"unknown attn_kernel {attn_kernel!r}")
    if staged_kv not in (False, True, "uniform"):
        raise ValueError(f"unknown staged_kv {staged_kv!r}")
    _check_cache(cache)
    if tp_axis is not None and (attn_o_kernel or mlp_kernel):
        raise ValueError("tp_axis does not support the attn_o/mlp "
                         "megakernels (their fused o/down contraction "
                         "would need an in-kernel all_reduce)")
    _check_tp(params, tp_axis)
    head_major = isinstance(cache, HeadMajorQuantKVCache)
    if attn_kernel == "ab" and not head_major:
        raise ValueError("attn_kernel='ab' requires a HeadMajorQuantKVCache "
                         f"(got {type(cache).__name__})")
    if attn_kernel == "ab" and attn_o_kernel:
        raise ValueError("attn_kernel='ab' and attn_o_kernel=True are "
                         "mutually exclusive (the fused attention+o "
                         "kernel uses the row grid)")
    if mlp_kernel and not _mlp_kernel_supported(params):
        raise ValueError("mlp_kernel=True requires int8-factor fused params "
                         "with factor_kernel 'l'/'lr' and lane-aligned rank "
                         "(quantize_factors_int8_fused(..., "
                         "fuse_factor_kernel='l'))")
    if attn_o_kernel and not (head_major
                              and _attn_o_kernel_supported(params, config)):
        raise ValueError("attn_o_kernel=True requires a head-major cache, "
                         "an MHA config (num_heads == num_kv_heads), and "
                         "an int8-factor w4a8 o_proj with lane-aligned "
                         "rank")
    if attn_o_kernel and attn_dots != "f32":
        raise ValueError("attn_o_kernel=True supports attn_dots='f32' "
                         f"only, got {attn_dots!r}")
    if staged_kv and not head_major:
        raise ValueError("staged_kv requires a HeadMajorQuantKVCache")
    if proj_kernel not in ("grid", "persistent"):
        raise ValueError(f"unknown proj_kernel {proj_kernel!r}")
    if head_major:
        AT._check_dots(attn_dots)
    del head_pallas
    resolve_device(tokens.device)
    x, cache = _decode_layers(params.layers, params.embed[tokens].float(),
                              pos, cache, config, staged_kv, attn_kernel,
                              attn_o_kernel, mlp_kernel, attn_dots,
                              proj_kernel, tp_axis)
    logits = llama._logits(x, params.embed, params.final_norm,
                           params.lm_head, config)
    return logits, cache


def _decode_layers(lp: FusedLayerStack, x: torch.Tensor, pos: torch.Tensor,
                   cache, config: ModelConfig, staged_kv, attn_kernel: str,
                   attn_o_kernel: bool, mlp_kernel: bool, attn_dots: str,
                   proj_kernel: str, tp_axis, row0: int = 0):
    """The ``config.num_layers`` layers of a decode step on one-token rows
    ``x`` (B, h), options as :func:`decode_step_fused` checked them; rows
    ``b`` of ``x`` are cache rows ``row0 + b`` (the fused attention + o_proj
    kernel reads the whole cache: ``row0`` 0 there). Returns ``(x, cache)``,
    the cache written in place."""
    B = x.shape[0]
    Lk, KVH, D = config.num_layers, config.num_kv_heads, config.head_dim
    kv_groups = config.num_heads // KVH
    dev = x.device
    head_major = isinstance(cache, HeadMajorQuantKVCache)
    T = cache.k.shape[3] if head_major else cache.k.shape[2]
    cos, sin = llama.rope_tables(config, pos[:, None])
    rows = torch.arange(B, device=dev)
    mb = slice(row0, row0 + B)
    col = pos.long()
    mask = None
    if not head_major:
        valid = torch.arange(T, device=dev)[None, :] <= col[:, None]
        mask = llama._mask(valid)[:, None, None, None, :]
    if staged_kv:
        staging = (
            torch.empty((Lk, B, KVH, D), dtype=torch.int8, device=dev),
            torch.empty((Lk, B, KVH), dtype=torch.float32, device=dev),
            torch.empty((Lk, B, KVH, D), dtype=torch.int8, device=dev),
            torch.empty((Lk, B, KVH), dtype=torch.float32, device=dev))
    for l in range(Lk):
        q, k, v = _qkv(lp, l, x, cos, sin, config, (B, 1))
        if head_major:
            kq, ksc = llama.quantize_kv(k[:, 0])
            vq, vsc = llama.quantize_kv(v[:, 0])
            qh = q[:, 0].reshape(B, KVH, kv_groups, D)
            # layer l's block of the rows, contiguous: the decode kernels
            # take it as a one-layer cache
            kv = tuple(t[l:l + 1, mb] for t in (cache.k, cache.v,
                                                cache.k_scale, cache.v_scale))
            kf = vf = None
            if staged_kv:
                for buf, val in zip(staging, (kq, ksc, vq, vsc)):
                    buf[l] = val
                kf = kq.float() * ksc[..., None]
                vf = vq.float() * vsc[..., None]
            else:
                # per-row write at pos[b] (clamped, as the reference's
                # dynamic_update_slice), then attend tokens <= pos
                ccol = col.clamp(0, T - 1)
                for t, val in zip(kv, (kq, vq, ksc, vsc)):
                    t[0][rows, :, ccol] = val
            if attn_o_kernel:
                attn = _attn_o(lp.o_proj, l, qh, cache, kf, vf, pos)
            elif attn_kernel == "ab":
                attn = AT.flash_decode_q8_ab(qh, *kv, kf, vf, 0, pos,
                                             staged=bool(staged_kv),
                                             dots=attn_dots)
            elif staged_kv:
                attn = AT.flash_decode_q8_staged(qh, *kv, kf, vf, 0, pos,
                                                 dots=attn_dots)
            else:
                attn = AT.flash_decode_q8(qh, *kv, 0, pos, dots=attn_dots)
        elif isinstance(cache, QuantKVCache):
            kq, ksc = llama.quantize_kv(k[:, 0])
            vq, vsc = llama.quantize_kv(v[:, 0])
            kv = tuple(t[l, mb] for t in (cache.k, cache.v, cache.k_scale,
                                          cache.v_scale))
            for t, val in zip(kv, (kq, vq, ksc, vsc)):
                t[rows, col] = val
            attn = llama._attention_q8(q, *kv, mask)
        else:
            ck, cv = cache.k[l, mb], cache.v[l, mb]
            ck[rows, col] = k[:, 0].to(ck.dtype)
            cv[rows, col] = v[:, 0].to(cv.dtype)
            attn = llama._attention(q, ck, cv, mask)
        if attn_o_kernel:               # o_proj already applied
            x = x + attn * lp.o_proj.global_scale[l]
        else:
            x = x + _tp_sum(_apply_plain(
                lp.o_proj, l, attn.reshape(B, config.q_dim),
                lp.qkv.factor_kernel, proj_kernel, tp_axis), tp_axis)
        x = _mlp(lp, l, x, config, mlp_kernel, proj_kernel, tp_axis)
    if staged_kv:
        _commit(cache, staging, pos, row0)
    return x, cache


def prefill_into_slot_fused(params: FusedStackedParams, tokens: torch.Tensor,
                            slot: int, cache, config: ModelConfig,
                            last_pos: Optional[int] = None,
                            flash: bool = False, proj_kernel: str = "grid",
                            tp_axis=None):
    """Prefill one (1, S) prompt into batch row ``slot`` of the cache, on
    the fused path.

    The prompt's own causal self-attention runs on the f32 K/V of this
    call: :func:`ops.attention.flash_prefill` (a CUDA kernel on the card)
    when ``flash``, else the plain attention with a causal mask. The K/V of
    all S tokens (a bucket's pad tokens too) are written into the cache at
    columns ``0 .. S-1``, in place. Returns ``(logits (vocab,) f32 of row
    last_pos (the last row when None), cache)``. ``proj_kernel`` is accepted
    and not used, as in the reference: its prefill runs o and down on the
    grid kernel whatever the flag. ``tp_axis``: as in
    :func:`decode_step_fused` (the logits the rank's vocabulary shard).
    """
    if proj_kernel not in ("grid", "persistent"):
        raise ValueError(f"unknown proj_kernel {proj_kernel!r}")
    _check_cache(cache)
    _check_tp(params, tp_axis)
    resolve_device(tokens.device)
    lp = params.layers
    S = tokens.shape[1]
    dev = tokens.device
    x = params.embed[tokens[0]].float()
    cos, sin = llama.rope_tables(config, torch.arange(S, device=dev)[None])
    mask = None
    if not flash:
        mask = llama._causal(S, dev)
    for l in range(config.num_layers):
        q, k, v = _qkv(lp, l, x, cos, sin, config, (1, S))
        if flash:
            attn = AT.flash_prefill(q, k, v)
        else:
            attn = llama._attention(q, k, v, mask)
        llama._write_prompt_kv(cache, l, slot, 0, k, v)
        x = _mlp_and_o(lp, l, x, attn.reshape(S, config.q_dim), config,
                       tp_axis=tp_axis)
    return _last_logits(params, x, last_pos, config), cache


def decode_layers_fused(lp: FusedLayerStack, x: torch.Tensor,
                        pos: torch.Tensor, cache: HeadMajorQuantKVCache,
                        config: ModelConfig, tp_axis=None,
                        proj_kernel: str = "grid", attn_dots: str = "f32",
                        row0: int = 0):
    """Run ``config.num_layers`` fused W4A8 layers on one-token rows ``x``
    (B, h) over a layer-stacked head-major int8 cache whose leading dim is
    ``config.num_layers``: the layers of :func:`decode_step_fused` with
    ``staged_kv=True`` on the row kernel (staged flash attention, one
    per-row commit at the end), for the pipeline-parallel step
    (``parallel.pp``), where each stage runs its slice of the layers. Rows
    ``b`` of ``x`` are cache rows ``row0 + b`` (a stage's microbatch). The
    embedding and the head stay with the caller. ``tp_axis``,
    ``proj_kernel``, ``attn_dots``: as in :func:`decode_step_fused` (the
    reference's layer body takes f32 dots). Returns ``(x, cache)``, the
    cache written in place."""
    if not isinstance(cache, HeadMajorQuantKVCache):
        raise ValueError("decode_layers_fused requires a "
                         f"HeadMajorQuantKVCache, got {type(cache).__name__}")
    AT._check_dots(attn_dots)
    return _decode_layers(lp, x, pos, cache, config, True, "row", False,
                          False, attn_dots, proj_kernel, tp_axis, row0)


def prefill_chunk_fused(params: FusedStackedParams, tokens: torch.Tensor,
                        slot: int, offset: int, cache, config: ModelConfig,
                        last_pos: Optional[int] = None):
    """Prefill one (1, C) chunk of a prompt at position ``offset`` into
    batch row ``slot`` (chunked prefill for continuous batching).

    The chunk's K/V are written at ``offset`` first (clamped so the chunk
    fits, as the reference's dynamic_update_slice); then the chunk attends
    every cache position ``<= offset + i`` of its row (earlier chunks and
    itself, causally) with the plain attention over that row. ``last_pos``
    is chunk-relative; the logits (vocab,) are meaningful on a prompt's last
    chunk. Returns ``(logits, cache)``; the cache is updated in place.
    """
    _check_cache(cache)
    resolve_device(tokens.device)
    head_major = isinstance(cache, HeadMajorQuantKVCache)
    lp = params.layers
    C = tokens.shape[1]
    dev = tokens.device
    T = cache.k.shape[3] if head_major else cache.k.shape[2]
    x = params.embed[tokens[0]].float()
    positions = offset + torch.arange(C, device=dev)
    cos, sin = llama.rope_tables(config, positions[None])
    valid = torch.arange(T, device=dev)[None, :] <= positions[:, None]
    mask = llama._mask(valid)[None, None, None]
    start = min(max(int(offset), 0), T - C)
    for l in range(config.num_layers):
        q, k, v = _qkv(lp, l, x, cos, sin, config, (1, C))
        llama._write_prompt_kv(cache, l, slot, start, k, v)
        if head_major:
            attn = llama._attention_q8(
                q, cache.k[l, slot].transpose(0, 1)[None],
                cache.v[l, slot].transpose(0, 1)[None],
                cache.k_scale[l, slot].T[None],
                cache.v_scale[l, slot].T[None], mask)
        elif isinstance(cache, QuantKVCache):
            attn = llama._attention_q8(
                q, cache.k[l, slot][None], cache.v[l, slot][None],
                cache.k_scale[l, slot][None], cache.v_scale[l, slot][None],
                mask)
        else:
            attn = llama._attention(q, cache.k[l, slot][None],
                                    cache.v[l, slot][None], mask)
        x = _mlp_and_o(lp, l, x, attn.reshape(C, config.q_dim), config)
    return _last_logits(params, x, last_pos, config), cache

