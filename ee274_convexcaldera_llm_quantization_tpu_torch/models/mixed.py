"""Mixed-precision serving: per-(layer, projection) bit widths, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.mixed``.
A budgeted allocation (``allocate.multigroup`` through
``surgery.compress_model_with_budget``) gives every projection of every
layer its own width, but a stacked W4A8 launch takes one width per stack.
So for each projection the layers are partitioned into **bit-width
buckets**: each bucket stacks its member layers' packed codes, scales and
factors (one static ``num_bits``), and two maps locate global layer ``l``
as (bucket, index within the bucket). Layers the quality gate left dense
ride in a stacked :class:`DenseLinear` bucket (a bf16 product with f32
sums, plain PyTorch: no Pallas kernel computes it in the reference).

The reference dispatches a bucket with ``lax.switch`` on a device index
inside one compiled layer body. Here the loop over layers runs on the host
and picks the bucket from the static maps (``bucket_of_static``,
``index_in_static``), so no device value is read back in the loop, and the
switch path (:func:`decode_step_mixed`) and the segmented path
(:func:`decode_step_mixed_segmented`, the reference's run-partitioned
decode) compute the same thing. Both entry points stay, as callers and the
reference's tests name both.

On the card every CALDERA bucket is one launch of the stacked W4A8 kernel
(``ops.kernels.quantized_matmul_w4a8_stacked``, the 2-, 4- or 8-bit
container; a 3-bit grid rides the 4-bit one) plus the factor dots; the
segmented path's fused groups (:func:`prepare_fused_segments`) are one
L-fused launch (``quantized_matmul_w4a8_l_stacked``) each; attention over
the head-major cache is the inline or staged row decode kernel; the int8
head is the int8 matmul kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models import stacked
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    HeadMajorQuantKVCache, ModelParams, QuantKVCache)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

_PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
               "up_proj", "down_proj")


@dataclasses.dataclass
class MixedProjection:
    """One projection across all layers, bucketed by bit width.

    ``buckets[j]`` is a stacked :class:`CalderaLinear` (leading axis = the
    bucket's member layers, in layer order; one ``num_bits``) or a stacked
    :class:`DenseLinear`. Global layer ``l`` is member
    ``index_in_static[l]`` of bucket ``bucket_of_static[l]``;
    ``bucket_of`` / ``index_in`` hold the same maps as int32 tensors on the
    params' device.
    """

    buckets: Tuple[object, ...]
    bucket_of: torch.Tensor              # (num_layers,) int32
    index_in: torch.Tensor               # (num_layers,) int32
    bucket_of_static: Tuple[int, ...] = ()
    index_in_static: Tuple[int, ...] = ()


@dataclasses.dataclass
class MixedLayerStack:
    attn_norm: torch.Tensor              # (layers, hidden)
    q_proj: MixedProjection
    k_proj: MixedProjection
    v_proj: MixedProjection
    o_proj: MixedProjection
    mlp_norm: torch.Tensor
    gate_proj: MixedProjection
    up_proj: MixedProjection
    down_proj: MixedProjection


@dataclasses.dataclass
class MixedStackedParams:
    embed: torch.Tensor
    layers: MixedLayerStack
    final_norm: torch.Tensor
    lm_head: Optional[object]


def _bucket_key(lin):
    if isinstance(lin, DenseLinear):
        return ("dense", tuple(lin.w.shape), lin.b is not None)
    if not isinstance(lin, CalderaLinear):
        raise TypeError(f"unsupported projection type {type(lin).__name__}")
    if lin.mode != "w4a8":
        raise ValueError(
            "mixed fast serving requires w4a8-mode CalderaLinear "
            f"projections (got mode={lin.mode!r}); recompress with "
            "serving_mode='w4a8'")
    return ("caldera", lin.num_bits, lin.grid_bits, tuple(lin.packed.shape),
            tuple(lin.L.shape), lin.b is not None, lin.L_scale is not None,
            lin.R_scale is not None)


def _maps(bucket_of, index_in, device) -> dict:
    return dict(bucket_of=torch.tensor(bucket_of, dtype=torch.int32,
                                       device=device),
                index_in=torch.tensor(index_in, dtype=torch.int32,
                                      device=device),
                bucket_of_static=tuple(bucket_of),
                index_in_static=tuple(index_in))


def _build_projection(lins) -> MixedProjection:
    keys = [_bucket_key(lin) for lin in lins]
    order = []                           # distinct keys, first-seen order
    for k in keys:
        if k not in order:
            order.append(k)
    index_in, counters = [], {k: 0 for k in order}
    for k in keys:
        index_in.append(counters[k])
        counters[k] += 1
    buckets = tuple(
        stacked._map_leaves(lambda *xs: torch.stack(xs),
                            *[lin for lin, kk in zip(lins, keys) if kk == k])
        for k in order)
    first = lins[0]
    device = (first.w if isinstance(first, DenseLinear)
              else first.packed).device
    return MixedProjection(
        buckets=buckets, **_maps([order.index(k) for k in keys], index_in,
                                 device))


def stack_layers_mixed(params: ModelParams) -> MixedStackedParams:
    """Bucket a (possibly heterogeneous) per-layer model for mixed serving.

    Accepts the output of ``surgery.compress_model_with_budget(...,
    serving_mode="w4a8")``: any combination of per-layer bit widths plus
    dense (reverted or uncompressed) layers."""
    lps = params.layers
    fields = {"attn_norm": torch.stack([lp.attn_norm for lp in lps]),
              "mlp_norm": torch.stack([lp.mlp_norm for lp in lps])}
    for name in _PROJ_NAMES:
        fields[name] = _build_projection([getattr(lp, name) for lp in lps])
    return MixedStackedParams(embed=params.embed,
                              layers=MixedLayerStack(**fields),
                              final_norm=params.final_norm,
                              lm_head=params.lm_head)


def num_bits_per_layer(mp: MixedProjection):
    """Per-layer bit widths of a projection (16 for dense buckets)."""
    widths = [b.num_bits if isinstance(b, CalderaLinear) else 16
              for b in mp.buckets]
    return [widths[i] for i in mp.bucket_of_static]


def _apply_bucket(bucket, idx: int, y: torch.Tensor) -> torch.Tensor:
    """Member ``idx`` of one bucket stack on activations ``y`` (M, in): a
    dense bucket is a bf16 product with f32 sums (operands upcast, exact);
    a CALDERA bucket one stacked W4A8 launch plus the factor dots, times
    the global scale, plus the bias."""
    if isinstance(bucket, DenseLinear):
        out = (y.to(torch.bfloat16).float()
               @ bucket.w[idx].to(torch.bfloat16).float().T)
        if bucket.b is not None:
            out = out + bucket.b[idx][None, :]
        return out
    yq = K.quantized_matmul_w4a8_stacked(y, bucket.packed, bucket.scales, idx,
                                         bucket.num_bits)
    out = (yq + stacked._low_rank_layer(bucket, idx, y)) * \
        bucket.global_scale[idx]
    if bucket.b is not None:
        out = out + bucket.b[idx][None, :]
    return out


def _apply_mixed(mp: MixedProjection, l: int, y: torch.Tensor):
    """Projection of global layer ``l``: the bucket the static map names,
    one kernel."""
    return _apply_bucket(mp.buckets[mp.bucket_of_static[l]],
                         mp.index_in_static[l], y)


def _decode_attention(cache, l: int, q, k, v, pos, rows, col, mask,
                      config: ModelConfig, dots: str = "f32"):
    """Write layer ``l``'s K/V of one token per row at column ``pos[b]``
    (int8-quantized for the int8 caches; the head-major write clamps into
    the cache as the reference's dynamic_update_slice does) and attend the
    tokens ``<= pos[b]``: the inline row decode kernel over the head-major
    cache, the plain attention over the token-major ones. Returns (B,
    q_dim)."""
    B = q.shape[0]
    if isinstance(cache, HeadMajorQuantKVCache):
        kq, ksc = llama.quantize_kv(k[:, 0])
        vq, vsc = llama.quantize_kv(v[:, 0])
        ccol = col.clamp(0, cache.k.shape[3] - 1)
        cache.k[l][rows, :, ccol] = kq
        cache.v[l][rows, :, ccol] = vq
        cache.k_scale[l][rows, :, ccol] = ksc
        cache.v_scale[l][rows, :, ccol] = vsc
        KVH = config.num_kv_heads
        qh = q[:, 0].reshape(B, KVH, config.num_heads // KVH,
                             config.head_dim)
        attn = AT.flash_decode_q8(qh, cache.k, cache.v, cache.k_scale,
                                  cache.v_scale, l, pos, dots=dots)
    elif isinstance(cache, QuantKVCache):
        kq, ksc = llama.quantize_kv(k[:, 0])
        vq, vsc = llama.quantize_kv(v[:, 0])
        cache.k[l][rows, col] = kq
        cache.v[l][rows, col] = vq
        cache.k_scale[l][rows, col] = ksc
        cache.v_scale[l][rows, col] = vsc
        attn = llama._attention_q8(q, cache.k[l], cache.v[l],
                                   cache.k_scale[l], cache.v_scale[l], mask)
    else:
        cache.k[l][rows, col] = k[:, 0].to(cache.k.dtype)
        cache.v[l][rows, col] = v[:, 0].to(cache.v.dtype)
        attn = llama._attention(q, cache.k[l], cache.v[l], mask)
    return attn.reshape(B, config.q_dim)


def _qkv_mixed(y: torch.Tensor, cos, sin, config: ModelConfig, apply,
               fused_qkv=None, seg_l: int = 0, lead=None):
    """q, k, v of the normed rows ``y`` (N, h) as (*lead, heads, D) (lead
    (N, 1) unless given), RoPE on q and k: one fused launch (``fused_qkv``,
    member ``seg_l``) or one bucket launch per projection through
    ``apply(name, y)``."""
    lead, D = lead or (y.shape[0], 1), config.head_dim
    if fused_qkv is not None:
        q, k, v = fused._apply_fused(fused_qkv, seg_l, y)
    else:
        q, k, v = (apply(n, y) for n in ("q_proj", "k_proj", "v_proj"))
    q = llama.apply_rope(q.reshape(*lead, config.num_heads, D), cos, sin)
    k = llama.apply_rope(k.reshape(*lead, config.num_kv_heads, D), cos, sin)
    return q, k, v.reshape(*lead, config.num_kv_heads, D)


def _mlp_mixed(lp: MixedLayerStack, l: int, x: torch.Tensor, attn,
               config: ModelConfig, apply, fused_gateup=None,
               seg_l: int = 0) -> torch.Tensor:
    """o_proj residual, RMSNorm, gate/up (one fused launch or two), SiLU and
    the down residual."""
    x = x + apply("o_proj", attn)
    y = llama.rms_norm(x, lp.mlp_norm[l], config.rms_norm_eps)
    if fused_gateup is not None:
        gate, up = fused._apply_fused(fused_gateup, seg_l, y)
    else:
        gate, up = apply("gate_proj", y), apply("up_proj", y)
    return x + apply("down_proj", gate * torch.sigmoid(gate) * up)


def _decode_setup(params, tokens, pos, cache, config):
    resolve_device(tokens.device)
    dev = tokens.device
    head_major = isinstance(cache, HeadMajorQuantKVCache)
    T = cache.k.shape[3] if head_major else cache.k.shape[2]
    x = params.embed[tokens].float()
    cos, sin = llama.rope_tables(config, pos[:, None])
    col = pos.long()
    mask = None
    if not head_major:
        valid = torch.arange(T, device=dev)[None, :] <= col[:, None]
        mask = llama._mask(valid)[:, None, None, None, :]
    return x, cos, sin, torch.arange(tokens.shape[0], device=dev), col, mask


def decode_step_mixed(params: MixedStackedParams, tokens: torch.Tensor,
                      pos: torch.Tensor, cache, config: ModelConfig):
    """Batched decode step over a mixed-precision bucketed model.

    Mirrors ``stacked.decode_step_w4a8`` with each projection dispatched
    through its bit-width bucket. ``tokens`` (B,) and ``pos`` (B,) on the
    params' device; ``cache`` a bf16 :class:`llama.KVCache`, an int8
    :class:`llama.QuantKVCache` (plain attention) or a
    :class:`llama.HeadMajorQuantKVCache` (the inline row decode kernel, f32
    dots), updated in place. Returns ``(logits (B, vocab) f32, cache)``.
    """
    fused._check_cache(cache)
    lp = params.layers
    x, cos, sin, rows, col, mask = _decode_setup(params, tokens, pos, cache,
                                                 config)
    for l in range(config.num_layers):
        def apply(name, y, l=l):
            return _apply_mixed(getattr(lp, name), l, y)
        y = llama.rms_norm(x, lp.attn_norm[l], config.rms_norm_eps)
        q, k, v = _qkv_mixed(y, cos, sin, config, apply)
        attn = _decode_attention(cache, l, q, k, v, pos, rows, col, mask,
                                 config)
        x = _mlp_mixed(lp, l, x, attn, config, apply)
    return llama._head(params, x, config), cache


def mixed_segments(layers: MixedLayerStack, num_layers: int):
    """Partition the layer sequence into maximal contiguous runs whose
    per-projection bucket signature is constant. Returns a list of
    ``(start, end, {proj_name: bucket_id})``."""
    sigs = [tuple(getattr(layers, n).bucket_of_static[l]
                  for n in _PROJ_NAMES) for l in range(num_layers)]
    runs, start = [], 0
    for l in range(1, num_layers + 1):
        if l == num_layers or sigs[l] != sigs[start]:
            runs.append((start, l, dict(zip(_PROJ_NAMES, sigs[start]))))
            start = l
    return runs


def _slice_leading(obj, i0: int, i1: int):
    """Members ``i0 .. i1 - 1`` of a stacked linear: every tensor's leading
    axis sliced (a view)."""
    return stacked._map_leaves(lambda t: t[i0:i1], obj)


def truncate_mixed(params: MixedStackedParams,
                   n_layers: int) -> MixedStackedParams:
    """Early-exit view of a mixed model: the first ``n_layers`` blocks as a
    standalone :class:`MixedStackedParams` sharing the embedding, final
    norm and head (every bucket a leading-axis view, no copy).

    Truncation keeps, for each bucket, the members of the kept layers, and
    that is a leading slice only if those members are the bucket's first
    ones. :func:`stack_layers_mixed` assigns members in layer order, which
    makes it so; the reference assumes it without a check, and here a
    projection whose maps break it raises ``ValueError``.
    """
    lp = params.layers
    if not 0 < n_layers <= lp.attn_norm.shape[0]:
        raise ValueError(f"cannot keep {n_layers} of "
                         f"{lp.attn_norm.shape[0]} layers")
    fields = {"attn_norm": lp.attn_norm[:n_layers],
              "mlp_norm": lp.mlp_norm[:n_layers]}
    for name in _PROJ_NAMES:
        mp = getattr(lp, name)
        keep = [(mp.bucket_of_static[l], mp.index_in_static[l])
                for l in range(n_layers)]
        used = []                        # surviving old bucket ids, in order
        for b, _ in keep:
            if b not in used:
                used.append(b)
        for b in used:
            kept = sorted(i for bb, i in keep if bb == b)
            if kept != list(range(len(kept))):
                raise ValueError(
                    f"{name}: bucket {b} keeps members {kept} of the first "
                    f"{n_layers} layers, not a leading prefix of its stack, "
                    "so the truncation is not a leading slice (ROADMAP R3)")
        counts = {b: sum(1 for bb, _ in keep if bb == b) for b in used}
        fields[name] = MixedProjection(
            buckets=tuple(_slice_leading(mp.buckets[b], 0, counts[b])
                          for b in used),
            **_maps([used.index(b) for b, _ in keep], [i for _, i in keep],
                    mp.bucket_of.device))
    return dataclasses.replace(params, layers=MixedLayerStack(**fields))


def prepare_fused_segments(params: MixedStackedParams, config: ModelConfig):
    """Per-segment fused qkv / gate+up stacks for the segmented decode.

    Within a run of one bucket signature, q/k/v (and gate/up) can be served
    as the uniform fused path serves them, one L-fused launch and one
    activation quantization per group, whenever their containers match.
    For each segment of :func:`mixed_segments` this builds ``{"qkv": ...,
    "gateup": ...}``, each a :class:`fused.FusedW4A8Linear` over the
    segment's layers (int8 factors, factor path "l") or None where the
    containers differ, a layer is dense, the factors are not int8, the
    ranks differ or are not multiples of 128, or
    ``ops.kernels.lr_stacked_supported`` refuses the group. The int8 factor
    codes and scales concatenate directly (R along the rank axis, L along
    N), so a fused group computes what its buckets compute up to the order
    of the f32 sums. The concatenations copy (GB-scale at 13B): build once
    at load and pass the result to ``decode_step_mixed_segmented(
    fused_prep=...)``. Every stack is a fresh contiguous tensor.
    """
    lp = params.layers

    def seg_lin(name, s, e, sig):
        mp = getattr(lp, name)
        i0 = mp.index_in_static[s]
        return _slice_leading(mp.buckets[sig[name]], i0, i0 + (e - s))

    def try_fuse(names, s, e, sig):
        lins = [seg_lin(n, s, e, sig) for n in names]
        if not all(isinstance(l, CalderaLinear) and l.mode == "w4a8"
                   and l.b is None and l.L_scale is not None
                   and l.R_scale is not None for l in lins):
            return None
        if len({l.num_bits for l in lins}) != 1:
            return None
        ranks = {l.L.shape[2] for l in lins}
        if len(ranks) != 1 or next(iter(ranks)) % 128:
            return None
        splits = tuple(l.packed.shape[1] for l in lins)
        rks = tuple(l.R.shape[1] for l in lins)
        if not K.lr_stacked_supported(splits, rks):
            return None
        return fused.FusedW4A8Linear(
            packed=torch.cat([l.packed for l in lins], dim=1),
            scales=torch.cat([l.scales for l in lins], dim=1),
            R=torch.cat([l.R for l in lins], dim=1),
            R_scale=torch.cat([l.R_scale for l in lins], dim=1),
            Ls=(),
            L_scales=tuple(l.L_scale for l in lins),
            L_cat=torch.cat([l.L for l in lins], dim=1),
            L_scale_cat=torch.cat([l.L_scale for l in lins], dim=1),
            global_scale=torch.stack(
                [l.global_scale.reshape(-1) for l in lins], dim=1),
            b=None, num_bits=lins[0].num_bits, splits=splits, ranks=rks,
            factor_kernel="l")

    return [{"qkv": try_fuse(("q_proj", "k_proj", "v_proj"), s, e, sig),
             "gateup": try_fuse(("gate_proj", "up_proj"), s, e, sig)}
            for (s, e, sig) in mixed_segments(lp, config.num_layers)]


def decode_step_mixed_segmented(params: MixedStackedParams,
                                tokens: torch.Tensor, pos: torch.Tensor,
                                cache: HeadMajorQuantKVCache,
                                config: ModelConfig, staged_kv: bool = True,
                                fused_prep=None, attn_dots: str = "f32"):
    """Mixed-precision decode over uniform-width runs (the reference's
    switch-free path, the 13B flagship's serving step).

    The layer sequence splits into runs of one bucket signature
    (:func:`mixed_segments`); each run's layers take their buckets
    statically. ``staged_kv`` True stages each layer's K/V, attends the
    cache's tokens ``< pos`` plus the staged token (the staged row decode
    kernel) and commits once at the end; False writes before the inline
    kernel, which is :func:`decode_step_mixed` bit for bit. ``fused_prep``
    (:func:`prepare_fused_segments`) serves a segment's qkv and gate/up as
    one L-fused launch each where it fused them. ``attn_dots``: "f32",
    "bf16" or "i8", the decode kernels' dots. Head-major int8 caches only;
    the cache is updated in place. Returns ``(logits (B, vocab) f32,
    cache)``.
    """
    if not isinstance(cache, HeadMajorQuantKVCache):
        raise ValueError("decode_step_mixed_segmented requires a "
                         "HeadMajorQuantKVCache")
    AT._check_dots(attn_dots)
    lp = params.layers
    x, cos, sin, rows, col, _ = _decode_setup(params, tokens, pos, cache,
                                              config)
    B, dev = tokens.shape[0], tokens.device
    Lk, KVH, D = config.num_layers, config.num_kv_heads, config.head_dim
    if staged_kv:
        staging = (torch.empty((Lk, B, KVH, D), dtype=torch.int8, device=dev),
                   torch.empty((Lk, B, KVH), dtype=torch.float32, device=dev),
                   torch.empty((Lk, B, KVH, D), dtype=torch.int8, device=dev),
                   torch.empty((Lk, B, KVH), dtype=torch.float32, device=dev))
    for i, (start, end, sig) in enumerate(mixed_segments(lp, Lk)):
        fp_run = fused_prep[i] if fused_prep is not None else {}
        for l in range(start, end):
            def apply(name, y, l=l):
                mp = getattr(lp, name)
                return _apply_bucket(mp.buckets[sig[name]],
                                     mp.index_in_static[l], y)
            y = llama.rms_norm(x, lp.attn_norm[l], config.rms_norm_eps)
            q, k, v = _qkv_mixed(y, cos, sin, config, apply,
                                 fp_run.get("qkv"), l - start)
            if staged_kv:
                kq, ksc = llama.quantize_kv(k[:, 0])
                vq, vsc = llama.quantize_kv(v[:, 0])
                for buf, val in zip(staging, (kq, ksc, vq, vsc)):
                    buf[l] = val
                qh = q[:, 0].reshape(B, KVH, config.num_heads // KVH, D)
                attn = AT.flash_decode_q8_staged(
                    qh, cache.k, cache.v, cache.k_scale, cache.v_scale,
                    kq.float() * ksc[..., None], vq.float() * vsc[..., None],
                    l, pos, dots=attn_dots).reshape(B, config.q_dim)
            else:
                attn = _decode_attention(cache, l, q, k, v, pos, rows, col,
                                         None, config, attn_dots)
            x = _mlp_mixed(lp, l, x, attn, config, apply,
                           fp_run.get("gateup"), l - start)
    if staged_kv:
        fused._commit(cache, staging, pos)
    return llama._head(params, x, config), cache


def prefill_into_slot_mixed(params: MixedStackedParams, tokens: torch.Tensor,
                            slot: int, cache, config: ModelConfig,
                            last_pos: Optional[int] = None):
    """Prefill one (1, S) prompt into batch row ``slot`` on the mixed path:
    the buckets take the S rows at once, the prompt attends its own f32 K/V
    causally (plain attention, as in the reference), and its K/V go into
    columns ``0 .. S-1`` of the cache (any of the three kinds, quantized for
    the int8 ones), in place. ``last_pos`` as in
    ``llama.prefill_into_slot``. Returns ``(logits (vocab,), cache)``."""
    fused._check_cache(cache)
    resolve_device(tokens.device)
    lp = params.layers
    S = tokens.shape[1]
    dev = tokens.device
    x = params.embed[tokens[0]].float()
    cos, sin = llama.rope_tables(config, torch.arange(S, device=dev)[None])
    mask = llama._causal(S, dev)
    for l in range(config.num_layers):
        def apply(name, y, l=l):
            return _apply_mixed(getattr(lp, name), l, y)
        y = llama.rms_norm(x, lp.attn_norm[l], config.rms_norm_eps)
        q, k, v = _qkv_mixed(y, cos, sin, config, apply, lead=(1, S))
        attn = llama._attention(q, k, v, mask).reshape(S, config.q_dim)
        llama._write_prompt_kv(cache, l, slot, 0, k, v)
        x = _mlp_mixed(lp, l, x, attn, config, apply)
    return llama._head(params, llama._last_row(x, last_pos), config)[0], cache
