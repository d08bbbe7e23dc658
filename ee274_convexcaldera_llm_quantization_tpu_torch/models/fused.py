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
    num_bits: int = 4
    splits: Tuple[int, ...] = ()
    ranks: Tuple[int, ...] = ()


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


def _quantize_fused_factors(fp: FusedW4A8Linear) -> FusedW4A8Linear:
    if fp.R_scale is not None:
        return fp
    R8, Rs = K.quantize_int8_rowwise(fp.R)
    pairs = [K.quantize_int8_rowwise(L) for L in fp.Ls]
    return dataclasses.replace(
        fp, R=R8, R_scale=Rs, Ls=tuple(c for c, _ in pairs),
        L_scales=tuple(s for _, s in pairs))


def quantize_factors_int8_fused(params: FusedStackedParams,
                                lm_head_int8: bool = True,
                                fuse_factor_kernel=False
                                ) -> FusedStackedParams:
    """int8-quantize all low-rank factors (and optionally the lm_head, or
    the tied embedding as a head) of a fused model.

    Only the ``"xla"`` factor path (``fuse_factor_kernel`` False / "xla":
    per-layer factor dots outside the packed kernel) is ported.
    """
    fk = {False: "xla", True: "lr"}.get(fuse_factor_kernel,
                                        fuse_factor_kernel)
    if fk in ("l", "lr"):
        raise NotImplementedError(
            f"factor path {fk!r} is not ported yet (ROADMAP.md, Queue B "
            "items 10-11)")
    if fk != "xla":
        raise ValueError(f"unknown factor kernel {fuse_factor_kernel!r}")
    lp = params.layers
    layers = FusedLayerStack(
        attn_norm=lp.attn_norm,
        qkv=_quantize_fused_factors(lp.qkv),
        o_proj=quantize_factors_int8(lp.o_proj),
        mlp_norm=lp.mlp_norm,
        gateup=_quantize_fused_factors(lp.gateup),
        down_proj=quantize_factors_int8(lp.down_proj))
    lm_head = params.lm_head
    if lm_head_int8:
        if lm_head is None:
            lm_head = quantize_linear_int8(DenseLinear(w=params.embed))
        elif isinstance(lm_head, DenseLinear):
            lm_head = quantize_linear_int8(lm_head)
    return FusedStackedParams(embed=params.embed, layers=layers,
                              final_norm=params.final_norm, lm_head=lm_head)


def _apply_fused(fp: FusedW4A8Linear, l: int, y: torch.Tensor):
    """One W4A8 launch + per-projection low-rank adds; returns a tuple of
    (B, N_i) outputs in fusion order."""
    yq = K.quantized_matmul_w4a8_stacked(y, fp.packed, fp.scales, l,
                                         fp.num_bits)
    xr = y.to(torch.bfloat16).float() @ fp.R[l].to(torch.bfloat16).float().T
    if fp.R_scale is not None:
        xr = xr * fp.R_scale[l][:, 0][None, :]
    gs_l = fp.global_scale[l]
    b_l = None if fp.b is None else fp.b[l]
    outs = []
    off_n = off_r = 0
    for i, (N_i, r_i) in enumerate(zip(fp.splits, fp.ranks)):
        ylr = (xr[:, off_r:off_r + r_i].to(torch.bfloat16).float()
               @ fp.Ls[i][l].to(torch.bfloat16).float().T)
        if fp.L_scales is not None:
            ylr = ylr * fp.L_scales[i][l][:, 0][None, :]
        out = (yq[:, off_n:off_n + N_i] + ylr) * gs_l[i]
        if b_l is not None:
            out = out + b_l[off_n:off_n + N_i][None, :]
        outs.append(out)
        off_n += N_i
        off_r += r_i
    return tuple(outs)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"{item})")


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


def _mlp_and_o(lp: FusedLayerStack, l: int, x: torch.Tensor,
               attn: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """The rest of a layer: o_proj residual, RMSNorm, gate/up, SiLU, down
    residual."""
    x = x + _apply_w4a8(lp.o_proj, l, attn)
    y = llama.rms_norm(x, lp.mlp_norm[l], config.rms_norm_eps)
    gate, up = _apply_fused(lp.gateup, l, y)
    return x + _apply_w4a8(lp.down_proj, l, gate * torch.sigmoid(gate) * up)


def _commit(cache: HeadMajorQuantKVCache, staging, pos: torch.Tensor):
    """Write each row's staged K/V (all layers) at column ``pos[b]`` of the
    cache, in place: one indexed write per cache tensor. Positions past the
    end clamp to the last column, as the reference's dynamic_update_slice
    does."""
    sk, sks, sv, svs = staging                 # (L, B, KVH[, D])
    T = cache.k.shape[3]
    rows = torch.arange(pos.shape[0], device=pos.device)
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
                      tp_axis: Optional[str] = None,
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
    block partition; head-major only). ``attn_dots``: "i8" or "f32".
    ``head_pallas`` is accepted and has no effect: the int8 head always
    runs the int8 matmul kernel on the card and its plain version on the
    CPU. Other flag values are not ported yet and raise.
    """
    if attn_kernel not in ("row", "ab"):
        raise ValueError(f"unknown attn_kernel {attn_kernel!r}")
    if staged_kv not in (False, True, "uniform"):
        raise ValueError(f"unknown staged_kv {staged_kv!r}")
    _check_cache(cache)
    head_major = isinstance(cache, HeadMajorQuantKVCache)
    if attn_kernel == "ab" and not head_major:
        raise ValueError("attn_kernel='ab' requires a HeadMajorQuantKVCache "
                         f"(got {type(cache).__name__})")
    if staged_kv and not head_major:
        raise ValueError("staged_kv requires a HeadMajorQuantKVCache")
    if mlp_kernel:
        raise _not_ported("mlp_kernel=True", "Queue B item 12")
    if attn_o_kernel:
        raise _not_ported("attn_o_kernel=True", "Queue B item 13")
    if tp_axis is not None:
        raise _not_ported("tp_axis", "Queue A item 19")
    if proj_kernel == "persistent":
        raise _not_ported("proj_kernel='persistent'", "Queue B item 14")
    if proj_kernel != "grid":
        raise ValueError(f"unknown proj_kernel {proj_kernel!r}")
    if head_major:
        AT._check_dots(attn_dots)
    del head_pallas
    resolve_device(tokens.device)
    lp = params.layers
    B = tokens.shape[0]
    Lk, KVH, D = config.num_layers, config.num_kv_heads, config.head_dim
    kv_groups = config.num_heads // KVH
    dev = tokens.device
    T = cache.k.shape[3] if head_major else cache.k.shape[2]
    x = params.embed[tokens].float()
    cos, sin = llama.rope_tables(config, pos[:, None])
    rows = torch.arange(B, device=dev)
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
            if staged_kv:
                for buf, val in zip(staging, (kq, ksc, vq, vsc)):
                    buf[l] = val
                kf = kq.float() * ksc[..., None]
                vf = vq.float() * vsc[..., None]
                if attn_kernel == "ab":
                    attn = AT.flash_decode_q8_ab(
                        qh, cache.k, cache.v, cache.k_scale, cache.v_scale,
                        kf, vf, l, pos, staged=True, dots=attn_dots)
                else:
                    attn = AT.flash_decode_q8_staged(
                        qh, cache.k, cache.v, cache.k_scale, cache.v_scale,
                        kf, vf, l, pos, dots=attn_dots)
            else:
                # per-row write at pos[b] (clamped, as the reference's
                # dynamic_update_slice), then attend tokens <= pos
                ccol = col.clamp(0, T - 1)
                cache.k[l][rows, :, ccol] = kq
                cache.v[l][rows, :, ccol] = vq
                cache.k_scale[l][rows, :, ccol] = ksc
                cache.v_scale[l][rows, :, ccol] = vsc
                if attn_kernel == "ab":
                    attn = AT.flash_decode_q8_ab(
                        qh, cache.k, cache.v, cache.k_scale, cache.v_scale,
                        None, None, l, pos, staged=False, dots=attn_dots)
                else:
                    attn = AT.flash_decode_q8(
                        qh, cache.k, cache.v, cache.k_scale, cache.v_scale,
                        l, pos, dots=attn_dots)
        elif isinstance(cache, QuantKVCache):
            kq, ksc = llama.quantize_kv(k[:, 0])
            vq, vsc = llama.quantize_kv(v[:, 0])
            cache.k[l][rows, col] = kq
            cache.v[l][rows, col] = vq
            cache.k_scale[l][rows, col] = ksc
            cache.v_scale[l][rows, col] = vsc
            attn = llama._attention_q8(q, cache.k[l], cache.v[l],
                                       cache.k_scale[l], cache.v_scale[l],
                                       mask)
        else:
            cache.k[l][rows, col] = k[:, 0].to(cache.k.dtype)
            cache.v[l][rows, col] = v[:, 0].to(cache.v.dtype)
            attn = llama._attention(q, cache.k[l], cache.v[l], mask)
        x = _mlp_and_o(lp, l, x, attn.reshape(B, config.q_dim), config)
    if staged_kv:
        _commit(cache, staging, pos)
    logits = llama._logits(x, params.embed, params.final_norm,
                           params.lm_head, config)
    return logits, cache


def prefill_into_slot_fused(params: FusedStackedParams, tokens: torch.Tensor,
                            slot: int, cache, config: ModelConfig,
                            last_pos: Optional[int] = None,
                            flash: bool = False):
    """Prefill one (1, S) prompt into batch row ``slot`` of the cache, on
    the fused path.

    The prompt's own causal self-attention runs on the f32 K/V of this
    call: :func:`ops.attention.flash_prefill` (a CUDA kernel on the card)
    when ``flash``, else the plain attention with a causal mask. The K/V of
    all S tokens (a bucket's pad tokens too) are written into the cache at
    columns ``0 .. S-1``, in place. Returns ``(logits (vocab,) f32 of row
    last_pos (the last row when None), cache)``.
    """
    _check_cache(cache)
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
        x = _mlp_and_o(lp, l, x, attn.reshape(S, config.q_dim), config)
    return _last_logits(params, x, last_pos, config), cache


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

