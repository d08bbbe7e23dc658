"""Llama/Qwen2-family transformer, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.llama``:
the params (:class:`LayerParams`, :class:`ModelParams`, whose projections
are any ``models.compressed`` linear), RMSNorm, rotary embeddings, KV
quantization, the KV caches (token-major bf16 and int8, head-major int8),
the plain attention the reference leaves to XLA, the output head, and the
model functions: :func:`forward`, :func:`prefill`, :func:`decode_step`,
:func:`decode_step_batched`, :func:`prefill_into_slot` and
:func:`generate_greedy`. Each projection goes through
:func:`models.compressed.apply_linear`, so a compressed model runs the
kernel of its serving mode on the card. Norms and softmax run in f32; bf16
dots upcast their operands to f32 (exact) and sum in f32, as the
reference's ``preferred_element_type=f32`` dots do. The steps update the
cache tensors in place and return the same cache (the reference returns a
new one).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    DenseLinear, apply_linear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)

_NEG_INF = -1e30


@dataclasses.dataclass
class LayerParams:
    """One transformer block's params; stacked (``models.stacked``), each
    leaf has a leading layer axis."""
    attn_norm: torch.Tensor
    q_proj: object
    k_proj: object
    v_proj: object
    o_proj: object
    mlp_norm: torch.Tensor
    gate_proj: object
    up_proj: object
    down_proj: object


@dataclasses.dataclass
class ModelParams:
    embed: torch.Tensor                # (vocab, hidden)
    layers: List[LayerParams]
    final_norm: torch.Tensor
    lm_head: Optional[object]          # None => tied with embed


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


@dataclasses.dataclass
class KVCache:
    """Token-major decode cache ``(L, B, T, KVH, D)``, bf16 by default. The
    steps update its tensors in place."""
    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(config: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        shape = (config.num_layers, batch, max_len, config.num_kv_heads,
                 config.head_dim)
        return KVCache(_zeros(shape, dtype, device),
                       _zeros(shape, dtype, device))


@dataclasses.dataclass
class QuantKVCache:
    """Token-major int8 KV cache ``(L, B, T, KVH, D)`` with per-(token,
    head) f32 scales ``(L, B, T, KVH)``, updated in place by the steps."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @staticmethod
    def create(config: ModelConfig, batch: int, max_len: int,
               device="cuda") -> "QuantKVCache":
        shape = (config.num_layers, batch, max_len, config.num_kv_heads,
                 config.head_dim)
        return QuantKVCache(_zeros(shape, torch.int8, device),
                            _zeros(shape, torch.int8, device),
                            _zeros(shape[:-1], torch.float32, device),
                            _zeros(shape[:-1], torch.float32, device))


@dataclasses.dataclass
class HeadMajorQuantKVCache:
    """int8 KV cache in head-major layout for the flash decode kernel.

    Layout ``(L, B, KVH, T, D)``: each (batch, kv-head) attention stream is
    a contiguous ``(T, D)`` slab. Scales are per-(token, head) f32
    ``(L, B, KVH, T)``. The decode step updates these tensors in place.
    """
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @staticmethod
    def create(config: ModelConfig, batch: int, max_len: int,
               device="cuda") -> "HeadMajorQuantKVCache":
        shape = (config.num_layers, batch, config.num_kv_heads, max_len,
                 config.head_dim)
        return HeadMajorQuantKVCache(_zeros(shape, torch.int8, device),
                                     _zeros(shape, torch.int8, device),
                                     _zeros(shape[:-1], torch.float32, device),
                                     _zeros(shape[:-1], torch.float32, device))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the trailing head_dim axis.

    ``x``: (..., KVH, D) -> (int8 codes, f32 scales (..., KVH)).
    """
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    scale = absmax / 127.0
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale[..., 0]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).float()


def rope_tables(config: ModelConfig, positions: torch.Tensor):
    """(cos, sin) of shape (..., head_dim/2) for the given positions."""
    half = config.head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    theta = torch.full_like(exps, config.rope_theta)   # no host copy
    inv_freq = 1.0 / torch.pow(theta, exps)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate pairs split as (first half, second half), HF Llama convention.

    ``x``: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim/2).
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, T, KVH, D); GQA by head broadcasting; an
    additive ``mask`` broadcasts as (B, 1, 1, S, T). Returns (B, S, H, D)
    f32."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    qg = q.float().reshape(B, S, KVH, H // KVH, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / _sqrt(D)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, D)


def _attention_q8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  ks: torch.Tensor, vs: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`_attention` over an int8 cache: ``k``/``v`` (B, T, KVH, D)
    int8, ``ks``/``vs`` (B, T, KVH) f32 folded into the logits (K side)
    and the probabilities (V side)."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    qg = q.float().reshape(B, S, KVH, H // KVH, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    logits = logits * (ks.float().permute(0, 2, 1)[:, :, None, None, :]
                       / _sqrt(D))
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    pv = probs * vs.float().permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkgst,btkd->bskgd", pv, v.float())
    return out.reshape(B, S, H, D)


def _sqrt(D: int) -> torch.Tensor:
    """``sqrt(D)`` in f32, as the reference divides by ``jnp.sqrt(f32(D))``."""
    return torch.sqrt(torch.tensor(float(D), dtype=torch.float32))


def _logits(x: torch.Tensor, embed: torch.Tensor, final_norm: torch.Tensor,
            lm_head: Optional[object], config: ModelConfig) -> torch.Tensor:
    """Final RMSNorm and output head: the int8 head runs the int8 matmul
    kernel on the card; a tied head is a bf16 dot with the embedding (both
    operands rounded to bf16, f32 sums)."""
    x = rms_norm(x, final_norm, config.rms_norm_eps)
    if lm_head is None:
        return (x.to(torch.bfloat16).float()
                @ embed.to(torch.bfloat16).float().T)
    return apply_linear(lm_head, x)


def init_params(seed: Union[int, torch.Generator], config: ModelConfig,
                dtype=torch.bfloat16, device="cuda") -> ModelParams:
    """Random dense params with the reference's shapes, types and scaling
    (N(0, 1/in) weights, 0.02 embedding, unit norms), drawn from
    ``torch.Generator`` ``seed`` (or one seeded with it) on ``device``. The
    values differ from the reference's, whose generator is JAX's."""
    dev = resolve_device(device)
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    h, im = config.hidden_size, config.intermediate_size

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * std).to(dtype)

    def dense(out_d, in_d, bias=False):
        b = torch.zeros((out_d,), dtype=dtype, device=dev) if bias else None
        return DenseLinear(w=normal((out_d, in_d), in_d ** -0.5), b=b)

    def ones():
        return torch.ones((h,), dtype=torch.float32, device=dev)

    layers = [LayerParams(
        attn_norm=ones(),
        q_proj=dense(config.q_dim, h, config.attention_bias),
        k_proj=dense(config.kv_dim, h, config.attention_bias),
        v_proj=dense(config.kv_dim, h, config.attention_bias),
        o_proj=dense(h, config.q_dim),
        mlp_norm=ones(),
        gate_proj=dense(im, h),
        up_proj=dense(im, h),
        down_proj=dense(h, im)) for _ in range(config.num_layers)]
    embed = normal((config.vocab_size, h), 0.02)
    lm_head = (None if config.tie_word_embeddings
               else dense(config.vocab_size, h))
    return ModelParams(embed=embed, layers=layers, final_norm=ones(),
                       lm_head=lm_head)


def _mask(valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, 0.0, _NEG_INF)


def _causal(S: int, device) -> torch.Tensor:
    """(1, 1, 1, S, S) additive causal mask."""
    return _mask(torch.ones((S, S), dtype=torch.bool,
                            device=device).tril())[None, None, None]


def _linears(lp: LayerParams):
    """``lin(name, y)``: the projection ``name`` of one block applied to
    ``y`` (..., in) through :func:`apply_linear`."""
    return lambda name, y: apply_linear(getattr(lp, name), y)


def _project_qkv(lin, y: torch.Tensor, config: ModelConfig, cos, sin):
    """q, k, v of the normed rows ``y`` (B, S, h) through ``lin(name, y)``
    (:func:`_linears`, or the stacked W4A8 path's), RoPE on q and k."""
    B, S, _ = y.shape
    D = config.head_dim
    q = lin("q_proj", y).reshape(B, S, config.num_heads, D)
    k = lin("k_proj", y).reshape(B, S, config.num_kv_heads, D)
    v = lin("v_proj", y).reshape(B, S, config.num_kv_heads, D)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp_and_o(lin, x: torch.Tensor, attn: torch.Tensor,
               mlp_norm: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """The rest of a block: o_proj residual, RMSNorm, SiLU(gate) * up and
    the down_proj residual."""
    x = x + lin("o_proj", attn)
    y = rms_norm(x, mlp_norm, config.rms_norm_eps)
    gate = lin("gate_proj", y)
    up = lin("up_proj", y)
    return x + lin("down_proj", gate * torch.sigmoid(gate) * up)


def _layer(x: torch.Tensor, lp: LayerParams, config: ModelConfig, cos, sin,
           mask, cache=None, l: int = 0, start: int = 0, rows=None,
           pos=None):
    """One transformer block on ``x`` (B, S, h).

    Without a cache the block attends its own K/V. With a bf16
    :class:`KVCache` it writes its K/V into layer ``l`` first, at columns
    ``start .. start + S - 1`` of every row, or, given ``rows``/``pos``
    (S = 1), at column ``pos[b]`` of row ``rows[b]``, and attends the whole
    cache under ``mask``.
    """
    B, S, _ = x.shape
    lin = _linears(lp)
    y = rms_norm(x, lp.attn_norm, config.rms_norm_eps)
    q, k, v = _project_qkv(lin, y, config, cos, sin)
    if cache is None:
        attn = _attention(q, k, v, mask)
    else:
        ck, cv = cache.k[l], cache.v[l]
        if rows is not None:
            ck[rows, pos] = k[:, 0].to(ck.dtype)
            cv[rows, pos] = v[:, 0].to(cv.dtype)
        else:
            ck[:, start:start + S] = k.to(ck.dtype)
            cv[:, start:start + S] = v.to(cv.dtype)
        attn = _attention(q, ck, cv, mask)
    return _mlp_and_o(lin, x, attn.reshape(B, S, config.q_dim), lp.mlp_norm,
                      config)


def _head(params, x: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    return _logits(x, params.embed, params.final_norm, params.lm_head, config)


def _start(pos: int, S: int, T: int) -> int:
    """A write of S columns at ``pos``, clamped into the cache as the
    reference's dynamic_update_slice clamps it."""
    return min(max(int(pos), 0), T - S)


def _last_row(x: torch.Tensor, last_pos) -> torch.Tensor:
    """Row ``last_pos`` of ``x`` (..., n, h), kept as a length-1 axis (the
    last row when None; clamped into range, as the reference's dynamic
    slice is)."""
    n = x.shape[-2]
    i = n - 1 if last_pos is None else min(max(int(last_pos), 0), n - 1)
    return x[..., i:i + 1, :]


def forward(params: ModelParams, tokens: torch.Tensor,
            config: ModelConfig) -> torch.Tensor:
    """Full-sequence forward (perplexity eval). ``tokens`` (B, S) on the
    params' device; returns logits (B, S, vocab) f32."""
    tokens = on_mesh(tokens, params.embed)
    B, S = tokens.shape
    dev = tokens.device
    x = params.embed[tokens].float()
    cos, sin = (on_mesh(t, params.embed) for t in rope_tables(
        config, torch.arange(S, device=dev)[None]))
    mask = on_mesh(_causal(S, dev), params.embed)
    for lp in params.layers:
        x = _layer(x, lp, config, cos, sin, mask)
    return _head(params, x, config)


def on_mesh(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` as a DTensor replicated over ``like``'s device mesh when
    ``like`` is a DTensor (params placed by ``parallel.mesh.shard_params``)
    and ``t`` is a plain tensor, the same on every rank; else ``t``. A
    DTensor op refuses plain tensor operands, so the tensors a model
    function makes itself (positions, RoPE tables, masks, given tokens) join
    the params' mesh here."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def prefill(params: ModelParams, tokens: torch.Tensor, cache: KVCache,
            config: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt (B, S) through the model, filling the cache from
    position 0 (in place). Returns (logits at the last position (B, vocab),
    cache)."""
    B, S = tokens.shape
    dev = tokens.device
    T = cache.k.shape[2]
    x = params.embed[tokens].float()
    cos, sin = rope_tables(config, torch.arange(S, device=dev)[None])
    valid = (torch.arange(T, device=dev)[None, :]
             <= torch.arange(S, device=dev)[:, None])
    mask = _mask(valid)[None, None, None]
    for i, lp in enumerate(params.layers):
        x = _layer(x, lp, config, cos, sin, mask, cache, i, 0)
    return _head(params, x[:, -1:], config)[:, 0], cache


def decode_step(params: ModelParams, token: torch.Tensor, pos,
                cache: KVCache, config: ModelConfig
                ) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step: ``token`` (B,), ``pos`` the current position
    of every row (an int or a 0-d tensor). Writes K/V at ``pos`` (in place)
    and returns (logits (B, vocab), cache)."""
    B = token.shape[0]
    dev = token.device
    T = cache.k.shape[2]
    p = int(pos)
    x = params.embed[token][:, None, :].float()
    cos, sin = rope_tables(config, torch.full((B, 1), p, device=dev))
    mask = _mask(torch.arange(T, device=dev) <= p)[None, None, None, None]
    for i, lp in enumerate(params.layers):
        x = _layer(x, lp, config, cos, sin, mask, cache, i, _start(p, 1, T))
    return _head(params, x, config)[:, 0], cache


def decode_step_batched(params: ModelParams, tokens: torch.Tensor,
                        pos: torch.Tensor, cache: KVCache,
                        config: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """One decode step with a per-row position vector (continuous
    batching): ``tokens`` (B,), ``pos`` (B,) int. Row ``b`` writes its K/V
    at ``pos[b]`` (in place) and attends tokens ``<= pos[b]``; rows of free
    slots compute too and the engine drops their output. Returns (logits
    (B, vocab), cache)."""
    B = tokens.shape[0]
    dev = tokens.device
    T = cache.k.shape[2]
    x = params.embed[tokens][:, None, :].float()
    cos, sin = rope_tables(config, pos[:, None])
    valid = torch.arange(T, device=dev)[None, :] <= pos[:, None]
    mask = _mask(valid)[:, None, None, None, :]
    rows = torch.arange(B, device=dev)
    col = pos.long()
    for i, lp in enumerate(params.layers):
        x = _layer(x, lp, config, cos, sin, mask, cache, i, rows=rows,
                   pos=col)
    return _head(params, x, config)[:, 0], cache


def prefill_into_slot(params: ModelParams, tokens: torch.Tensor, slot: int,
                      cache: KVCache, config: ModelConfig,
                      last_pos=None) -> Tuple[torch.Tensor, KVCache]:
    """Prefill one prompt (1, S) into batch row ``slot`` of a shared cache
    (in place), attending the prompt's own f32 K/V causally.

    ``last_pos`` picks the position whose logits are returned (S - 1 when
    None): a prompt right-padded to a length bucket writes pad K/V past its
    end, which no later step sees before overwriting it. Returns (logits
    (vocab,), cache).
    """
    S = tokens.shape[1]
    dev = tokens.device
    x = params.embed[tokens].float()
    cos, sin = rope_tables(config, torch.arange(S, device=dev)[None])
    mask = _causal(S, dev)
    for i, lp in enumerate(params.layers):
        lin = _linears(lp)
        y = rms_norm(x, lp.attn_norm, config.rms_norm_eps)
        q, k, v = _project_qkv(lin, y, config, cos, sin)
        attn = _attention(q, k, v, mask).reshape(1, S, config.q_dim)
        _write_prompt_kv(cache, i, slot, 0, k, v)
        x = _mlp_and_o(lin, x, attn, lp.mlp_norm, config)
    return _head(params, _last_row(x, last_pos), config)[0, 0], cache


def generate_greedy(params: ModelParams, prompt: torch.Tensor,
                    max_new_tokens: int, config: ModelConfig) -> torch.Tensor:
    """Greedy generation: ``prompt`` (B, S) on the params' device. Returns
    (B, S + max_new_tokens) tokens."""
    B, S = prompt.shape
    cache = KVCache.create(config, B, S + max_new_tokens,
                           device=prompt.device)
    logits, cache = prefill(params, prompt, cache, config)
    tokens = [logits.argmax(-1)]
    for step in range(max_new_tokens - 1):
        logits, cache = decode_step(params, tokens[-1], S + step, cache,
                                    config)
        tokens.append(logits.argmax(-1))
    return torch.cat([prompt, torch.stack(tokens, dim=1).to(prompt.dtype)],
                     dim=1)


def _write_prompt_kv(cache, l: int, slot: int, start: int, k, v):
    """Write (1, C, KVH, D) K/V of consecutive positions from ``start``
    into row ``slot`` of layer ``l`` (quantized for the int8 caches)."""
    C = k.shape[1]
    if isinstance(cache, KVCache):
        cache.k[l, slot, start:start + C] = k[0].to(cache.k.dtype)
        cache.v[l, slot, start:start + C] = v[0].to(cache.v.dtype)
        return
    kq, ksc = quantize_kv(k)          # (1, C, KVH, D), (1, C, KVH)
    vq, vsc = quantize_kv(v)
    kq, ksc, vq, vsc = kq[0], ksc[0], vq[0], vsc[0]
    if isinstance(cache, HeadMajorQuantKVCache):
        kq, vq = kq.transpose(0, 1), vq.transpose(0, 1)
        ksc, vsc = ksc.T, vsc.T
        cols = (slice(None), slice(start, start + C))
    else:
        cols = (slice(start, start + C),)
    cache.k[(l, slot) + cols] = kq
    cache.v[(l, slot) + cols] = vq
    cache.k_scale[(l, slot) + cols] = ksc
    cache.v_scale[(l, slot) + cols] = vsc
