"""Synthetic CALDERA-compressed Llama params built directly in packed form.

The port's counterpart of ``bench.py::build_compressed_llama_params``: only
shapes and dtypes matter for serving speed, so the packed codes, factors and
embeddings are drawn on the device from one seeded ``torch.Generator`` (the
bytes differ from the reference's, whose generator is JAX's; shapes and
dtypes are the same). A 7B model never exists as dense weights.
"""

from __future__ import annotations

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.stacked import (
    LayerParams, StackedModelParams)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops.kernels import (
    resolve_group)


def build_compressed_llama_params(config: ModelConfig, num_bits: int = 4,
                                  rank: int = 128, seed: int = 0,
                                  mode: str = "w4a8",
                                  device="cuda") -> StackedModelParams:
    """Layer-stacked compressed params with random packed codes, bf16
    rank-``rank`` factors (0.02 normal), per-row (w4a8) or grouped scales
    ``1 / sqrt(in) / 7``, a bf16 embedding and a bf16 untied lm_head."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, im = config.hidden_size, config.intermediate_size
    L = config.num_layers

    def normal_bf16(shape, std=0.02):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * std).to(torch.bfloat16)

    def qlin(out_d, in_d):
        G = in_d if mode == "w4a8" else resolve_group(num_bits, in_d, None)
        f = 8 // num_bits
        packed = torch.randint(0, 256, (L, out_d, in_d // f), generator=gen,
                               dtype=torch.uint8, device=dev)
        scales = torch.full((L, out_d, in_d // G), 1.0 / (in_d ** 0.5) / 7,
                            dtype=torch.float32, device=dev)
        r = min(rank, out_d, in_d)
        return CalderaLinear(
            packed=packed, scales=scales, L=normal_bf16((L, out_d, r)),
            R=normal_bf16((L, r, in_d)),
            global_scale=torch.ones((L,), dtype=torch.float32, device=dev),
            b=None, num_bits=num_bits, group_size=G, out_features=out_d,
            in_features=in_d, mode=mode)

    layers = LayerParams(
        attn_norm=torch.ones((L, h), dtype=torch.float32, device=dev),
        q_proj=qlin(config.q_dim, h),
        k_proj=qlin(config.kv_dim, h),
        v_proj=qlin(config.kv_dim, h),
        o_proj=qlin(h, config.q_dim),
        mlp_norm=torch.ones((L, h), dtype=torch.float32, device=dev),
        gate_proj=qlin(im, h),
        up_proj=qlin(im, h),
        down_proj=qlin(h, im))
    embed = normal_bf16((config.vocab_size, h))
    lm_head = DenseLinear(w=normal_bf16((config.vocab_size, h)))
    return StackedModelParams(
        embed=embed, layers=layers,
        final_norm=torch.ones((h,), dtype=torch.float32, device=dev),
        lm_head=lm_head)
