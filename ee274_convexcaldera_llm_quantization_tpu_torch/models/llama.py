"""Llama-family pieces of the decode step, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.llama``
for what the fused W4A8 prefill and decode steps need: RMSNorm, rotary
embeddings, KV quantization, the KV caches (token-major bf16 and int8,
head-major int8), the plain attention the reference leaves to XLA, and the
output head. Norms and softmax run in f32; bf16 dots upcast their operands
to f32 (exact) and sum in f32, as the reference's
``preferred_element_type=f32`` dots do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    apply_linear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)


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
