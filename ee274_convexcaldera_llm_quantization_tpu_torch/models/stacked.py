"""Layer-stacked model parameters and their model functions, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.stacked``:
every projection's tensors carry a leading layer axis, and a layer is an
index into them (a view, never a copy).

- :func:`forward`, :func:`decode_step_batched` and :func:`prefill` are the
  reference's scan path: here a loop over layer views (:func:`layer_view`)
  through ``llama._layer``, the block the reference's ``_layer_body``
  mirrors (so they equal the unrolled functions bit for bit), each
  projection through ``compressed.apply_linear`` and the kernel of its
  serving mode;
- :func:`decode_step_w4a8` and :func:`prefill_into_slot_w4a8` are the fast
  W4A8 path: each projection is one launch of the stacked W4A8 kernel on
  its layer (a pointer offset into the stack) plus the factor dots, over a
  bf16 :class:`llama.KVCache` or an int8 :class:`llama.QuantKVCache`.

Tensor parallelism (``tp_axis``) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear, quantize_factors_int8, quantize_linear_int8)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    KVCache, LayerParams, ModelParams, QuantKVCache)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
         "down_proj")


@dataclasses.dataclass
class StackedModelParams:
    embed: torch.Tensor
    layers: LayerParams          # leaves stacked: leading axis = num_layers
    final_norm: torch.Tensor
    lm_head: Optional[object]


def _map_leaves(fn, *objs):
    """``fn`` over the tensors of equal-structured params (dataclasses of
    tensors, None and static fields; static fields come from the first)."""
    first = objs[0]
    if isinstance(first, torch.Tensor):
        return fn(*objs)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _map_leaves(fn, *(getattr(o, f.name) for o in objs))
            for f in dataclasses.fields(first)})
    return first


def _homogeneous(layers) -> bool:
    def sig(lin):
        if isinstance(lin, DenseLinear):
            return ("dense", tuple(lin.w.shape), lin.b is not None)
        return ("caldera", tuple(lin.packed.shape), lin.num_bits,
                lin.group_size, tuple(lin.L.shape), lin.b is not None)
    first = [sig(getattr(layers[0], f)) for f in _PROJ]
    return all([sig(getattr(lp, f)) for f in _PROJ] == first
               for lp in layers[1:])


def stack_layers(params: ModelParams) -> StackedModelParams:
    """Stack per-layer params along a new leading axis (layers must be
    structurally homogeneous: same kinds, shapes, bit widths)."""
    if not _homogeneous(params.layers):
        raise ValueError(
            "layers are heterogeneous (mixed dense/compressed or differing "
            "shapes); use the unrolled models.llama functions instead")
    layers = _map_leaves(lambda *xs: torch.stack(xs), *params.layers)
    return StackedModelParams(embed=params.embed, layers=layers,
                              final_norm=params.final_norm,
                              lm_head=params.lm_head)


def layer_view(layers: LayerParams, l: int) -> LayerParams:
    """Layer ``l`` of stacked layer params: every tensor indexed (a view)."""
    return _map_leaves(lambda t: t[l], layers)


def _unrolled(params: StackedModelParams, config: ModelConfig) -> ModelParams:
    return ModelParams(params.embed,
                       [layer_view(params.layers, l)
                        for l in range(config.num_layers)],
                       params.final_norm, params.lm_head)


def quantize_model_factors_int8(params: StackedModelParams,
                                lm_head_int8: bool = True
                                ) -> StackedModelParams:
    """int8-quantize the low-rank factors of every compressed projection
    (and optionally the output head, or the tied embedding as a head) of a
    stacked model."""
    lp = params.layers
    layers = dataclasses.replace(lp, **{
        name: quantize_factors_int8(getattr(lp, name))
        for name in _PROJ if isinstance(getattr(lp, name), CalderaLinear)})
    lm_head = params.lm_head
    if lm_head_int8:
        if lm_head is None:
            lm_head = quantize_linear_int8(DenseLinear(w=params.embed))
        elif isinstance(lm_head, DenseLinear):
            lm_head = quantize_linear_int8(lm_head)
    return StackedModelParams(embed=params.embed, layers=layers,
                              final_norm=params.final_norm, lm_head=lm_head)


# The scan path: the unrolled model functions over layer views.

def forward(params: StackedModelParams, tokens: torch.Tensor,
            config: ModelConfig) -> torch.Tensor:
    """Full-sequence forward over the stacked layers (mirrors
    ``llama.forward``)."""
    return llama.forward(_unrolled(params, config), tokens, config)


def decode_step_batched(params: StackedModelParams, tokens: torch.Tensor,
                        pos: torch.Tensor, cache: KVCache,
                        config: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """Per-slot-position decode step over the stacked layers (mirrors
    ``llama.decode_step_batched``; the cache is updated in place)."""
    return llama.decode_step_batched(_unrolled(params, config), tokens, pos,
                                     cache, config)


def prefill(params: StackedModelParams, tokens: torch.Tensor, cache: KVCache,
            config: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """Prompt prefill over the stacked layers (mirrors ``llama.prefill``)."""
    return llama.prefill(_unrolled(params, config), tokens, cache, config)


# The fast W4A8 path.

def _low_rank_layer(lin: CalderaLinear, l: int, y: torch.Tensor):
    """Low-rank contribution ``y @ (L[l] @ R[l]).T`` for a stacked
    CalderaLinear (bf16 or int8 factors)."""
    return K.low_rank_matmul(
        y, lin.L[l], lin.R[l],
        None if lin.L_scale is None else lin.L_scale[l],
        None if lin.R_scale is None else lin.R_scale[l])


def _apply_w4a8(lin: CalderaLinear, l: int, y: torch.Tensor):
    """Layer ``l`` of a stacked w4a8 projection on ``y`` (..., in): one
    stacked W4A8 launch plus the low-rank term, global scale and bias."""
    y2 = y.reshape(-1, y.shape[-1])
    out = (K.quantized_matmul_w4a8_stacked(y2, lin.packed, lin.scales, l,
                                           lin.num_bits)
           + _low_rank_layer(lin, l, y2))
    out = out * lin.global_scale[l]
    if lin.b is not None:
        out = out + lin.b[l][None, :]
    return out.reshape(*y.shape[:-1], out.shape[-1])


def _w4a8_linears(lp: LayerParams, l: int):
    """``lin(name, y)`` of layer ``l`` on the stacked W4A8 path (see
    ``llama._linears``)."""
    return lambda name, y: _apply_w4a8(getattr(lp, name), l, y)


def _check_w4a8(lp: LayerParams, tp_axis) -> None:
    if tp_axis is not None:
        raise NotImplementedError("tp_axis is not ported yet (ROADMAP.md, "
                                  "Queue A item 19)")
    for name in _PROJ:
        lin = getattr(lp, name)
        if not isinstance(lin, CalderaLinear) or lin.mode != "w4a8":
            raise ValueError(f"{name} must be a stacked w4a8 CalderaLinear, "
                             f"got {type(lin).__name__} "
                             f"mode={getattr(lin, 'mode', None)}")


def _check_cache(cache) -> None:
    if not isinstance(cache, (KVCache, QuantKVCache)):
        raise TypeError("the W4A8 path takes a KVCache or a QuantKVCache, "
                        f"got {type(cache).__name__}")


def decode_layers_w4a8(lp: LayerParams, x: torch.Tensor, pos: torch.Tensor,
                       cache, config: ModelConfig,
                       tp_axis: Optional[str] = None):
    """Run ``config.num_layers`` stacked w4a8 layers on one-token rows ``x``
    (B, h), writing row ``b``'s K/V at ``[l, b, pos[b]]`` (in place,
    int8-quantized for a :class:`llama.QuantKVCache`) and attending tokens
    ``<= pos[b]``. The block is ``models.llama``'s, each projection one
    stacked W4A8 launch. Returns ``(x, cache)``."""
    _check_w4a8(lp, tp_axis)
    _check_cache(cache)
    B = x.shape[0]
    dev = x.device
    x = x[:, None, :]
    T = cache.k.shape[2]
    cos, sin = llama.rope_tables(config, pos[:, None])
    valid = torch.arange(T, device=dev)[None, :] <= pos[:, None]
    mask = llama._mask(valid)[:, None, None, None, :]
    rows = torch.arange(B, device=dev)
    col = pos.long()
    for l in range(config.num_layers):
        lin = _w4a8_linears(lp, l)
        y = llama.rms_norm(x, lp.attn_norm[l], config.rms_norm_eps)
        q, k, v = llama._project_qkv(lin, y, config, cos, sin)
        if isinstance(cache, QuantKVCache):
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
        x = llama._mlp_and_o(lin, x, attn.reshape(B, 1, config.q_dim),
                             lp.mlp_norm[l], config)
    return x[:, 0], cache


def decode_step_w4a8(params: StackedModelParams, tokens: torch.Tensor,
                     pos: torch.Tensor, cache, config: ModelConfig,
                     tp_axis: Optional[str] = None):
    """Decode step on the stacked W4A8 path: ``tokens`` (B,), ``pos`` (B,)
    on the params' device; every projection must be a stacked w4a8
    :class:`CalderaLinear`. The cache (bf16 :class:`llama.KVCache` or int8
    :class:`llama.QuantKVCache`) is updated in place. Returns ``(logits
    (B, vocab) f32, cache)``."""
    x = params.embed[tokens].float()
    x, cache = decode_layers_w4a8(params.layers, x, pos, cache, config,
                                  tp_axis)
    return llama._head(params, x[:, None, :], config)[:, 0], cache


def prefill_into_slot_w4a8(params: StackedModelParams, tokens: torch.Tensor,
                           slot: int, cache, config: ModelConfig,
                           last_pos=None, tp_axis: Optional[str] = None):
    """Prefill one prompt (1, S) into batch row ``slot`` on the stacked W4A8
    path (the W4A8 kernel takes the S rows at once). The prompt attends its
    own f32 K/V causally; the cache write is int8-quantized for a
    :class:`llama.QuantKVCache`. ``last_pos`` as in
    ``llama.prefill_into_slot``. Returns ``(logits (vocab,), cache)``."""
    _check_w4a8(params.layers, tp_axis)
    _check_cache(cache)
    lp = params.layers
    S = tokens.shape[1]
    dev = tokens.device
    x = params.embed[tokens].float()
    cos, sin = llama.rope_tables(config, torch.arange(S, device=dev)[None])
    mask = llama._causal(S, dev)
    for l in range(config.num_layers):
        lin = _w4a8_linears(lp, l)
        y = llama.rms_norm(x, lp.attn_norm[l], config.rms_norm_eps)
        q, k, v = llama._project_qkv(lin, y, config, cos, sin)
        attn = llama._attention(q, k, v, mask)
        llama._write_prompt_kv(cache, l, slot, 0, k, v)
        x = llama._mlp_and_o(lin, x, attn.reshape(1, S, config.q_dim),
                             lp.mlp_norm[l], config)
    x_last = llama._last_row(x, last_pos)
    return llama._head(params, x_last, config)[0, 0], cache
