"""Hugging Face checkpoint export (local directories), in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.
hf_export``, the inverse of :mod:`models.hf_import`: writes dense
:class:`llama.ModelParams` as ``config.json`` plus one ``model.safetensors``
in the HF Llama layout (f32 tensors, the same keys), with the port's own
safetensors writer. Compressed models go through :mod:`utils.checkpoint`.
"""

from __future__ import annotations

import json
import os

from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    _safetensors)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    DenseLinear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.hf_import import (
    _HF_PROJ)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    ModelParams)


def config_to_hf(config: ModelConfig, model_type: str = "llama") -> dict:
    """Translate :class:`ModelConfig` to the HF LlamaConfig/Qwen2Config
    schema (the keys ``hf_import.config_from_hf`` reads back)."""
    return {
        "model_type": model_type,
        "architectures": ["LlamaForCausalLM" if model_type == "llama"
                          else "Qwen2ForCausalLM"],
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads,
        "head_dim": config.head_dim,
        "rope_theta": config.rope_theta,
        "rms_norm_eps": config.rms_norm_eps,
        "max_position_embeddings": config.max_seq_len,
        "attention_bias": config.attention_bias,
        "tie_word_embeddings": config.tie_word_embeddings,
        "torch_dtype": "float32",
    }


def _f32(t):
    return t.detach().float().cpu().numpy()


def save_hf_checkpoint(path: str, params: ModelParams, config: ModelConfig,
                       model_type: str = "llama") -> None:
    """Write ``config.json`` + ``model.safetensors`` (f32) in HF Llama
    layout. Requires dense params: a compressed linear raises
    ``ValueError``."""
    os.makedirs(path, exist_ok=True)
    state = {}

    def put_linear(key: str, lin) -> None:
        if not isinstance(lin, DenseLinear):
            raise ValueError(
                f"{key}: HF export requires dense weights, got "
                f"{type(lin).__name__} (use utils.checkpoint for "
                "compressed models)")
        state[f"{key}.weight"] = _f32(lin.w)
        if lin.b is not None:
            state[f"{key}.bias"] = _f32(lin.b)

    state["model.embed_tokens.weight"] = _f32(params.embed)
    for i, lp in enumerate(params.layers):
        base = f"model.layers.{i}"
        state[f"{base}.input_layernorm.weight"] = _f32(lp.attn_norm)
        state[f"{base}.post_attention_layernorm.weight"] = _f32(lp.mlp_norm)
        for ours, hf in _HF_PROJ.items():
            put_linear(f"{base}.{hf}", getattr(lp, ours))
    state["model.norm.weight"] = _f32(params.final_norm)
    if params.lm_head is not None and not config.tie_word_embeddings:
        put_linear("lm_head", params.lm_head)

    _safetensors.save_file(state, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_hf(config, model_type), f, indent=2)
