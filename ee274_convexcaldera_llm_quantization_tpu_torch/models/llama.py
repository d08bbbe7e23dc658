"""Llama-family pieces of the decode step, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.llama``
for what the fused W4A8 decode step needs: RMSNorm, rotary embeddings, KV
quantization, the head-major int8 KV cache and the output head. Norms and
softmax run in f32; bf16 dots upcast their operands to f32 (exact) and sum
in f32, as the reference's ``preferred_element_type=f32`` dots do.
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
        dev = resolve_device(device)
        shape = (config.num_layers, batch, config.num_kv_heads, max_len,
                 config.head_dim)
        return HeadMajorQuantKVCache(
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev))


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


def _logits(x: torch.Tensor, embed: torch.Tensor, final_norm: torch.Tensor,
            lm_head: Optional[object], config: ModelConfig) -> torch.Tensor:
    """Final RMSNorm and output head: the int8 head runs the int8 matmul
    kernel on the card; a tied head is a bf16 dot with the embedding."""
    x = rms_norm(x, final_norm, config.rms_norm_eps)
    if lm_head is None:
        return x.to(torch.bfloat16).float() @ embed.float().T
    return apply_linear(lm_head, x)
