"""Hugging Face checkpoint import (local directories), in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.
hf_import``: maps a local Llama/Qwen2 checkpoint directory (``config.json``
plus ``*.safetensors`` or ``pytorch_model*.bin`` shards) onto the port's
:class:`llama.ModelParams`, with the same key schema, including the
LLaVA-OneVision language tower (keys prefixed ``language_model.``).
Safetensors shards are read by the port's own reader
(``models._safetensors``), BF16 included, as the reference reads them
(ROADMAP.md, R12).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    _safetensors)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    DenseLinear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    LayerParams, ModelParams)

_HF_PROJ = {
    "q_proj": "self_attn.q_proj",
    "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj",
    "o_proj": "self_attn.o_proj",
    "gate_proj": "mlp.gate_proj",
    "up_proj": "mlp.up_proj",
    "down_proj": "mlp.down_proj",
}


def config_from_hf(hf: dict) -> ModelConfig:
    """Translate an HF ``config.json`` (LlamaConfig/Qwen2Config schema; a
    multimodal wrapper's ``text_config``)."""
    if "text_config" in hf:
        hf = hf["text_config"]
    num_heads = hf["num_attention_heads"]
    head_dim = hf.get("head_dim") or hf["hidden_size"] // num_heads
    return ModelConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=head_dim,
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=hf.get("max_position_embeddings", 4096),
        attention_bias=hf.get("attention_bias",
                              hf.get("model_type") == "qwen2"),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory's safetensors shards (in their
    stored dtypes), or else of its ``pytorch_model*.bin`` shards (as f32),
    on the CPU."""
    state: Dict[str, torch.Tensor] = {}
    st_files = sorted(f for f in os.listdir(path)
                      if f.endswith(".safetensors"))
    if st_files:
        for fname in st_files:
            state.update(_safetensors.load_file(os.path.join(path, fname)))
        return state
    bin_files = sorted(f for f in os.listdir(path)
                       if f.startswith("pytorch_model") and
                       f.endswith(".bin"))
    if bin_files:
        for fname in bin_files:
            sd = torch.load(os.path.join(path, fname), map_location="cpu",
                            weights_only=True)
            for k, v in sd.items():
                state[k] = v.float()
        return state
    raise FileNotFoundError(f"no safetensors/bin weights under {path}")


def _strip_prefix(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Normalize key prefixes: ``language_model.model.``,
    ``language_model.``, ``model.``, in that order."""
    out = {}
    for k, v in state.items():
        for prefix in ("language_model.model.", "language_model.", "model.",
                       ""):
            if k.startswith(prefix):
                out[k[len(prefix):]] = v
                break
    return out


def params_from_state_dict(state, config: ModelConfig, dtype=None,
                           device="cuda") -> ModelParams:
    """Build :class:`ModelParams` on ``device`` from an HF state dict of
    tensors: weights in ``dtype`` (bf16 by default), norms and biases in
    f32."""
    dev = resolve_device(device)
    dtype = dtype or torch.bfloat16
    state = _strip_prefix(state)

    def tensor(key, dt):
        return state[key].to(dev).to(dt)

    def lin(prefix):
        b = None
        if f"{prefix}.bias" in state:
            b = tensor(f"{prefix}.bias", torch.float32)
        return DenseLinear(w=tensor(f"{prefix}.weight", dtype), b=b)

    layers = []
    for i in range(config.num_layers):
        base = f"layers.{i}"
        fields = dict(
            attn_norm=tensor(f"{base}.input_layernorm.weight",
                             torch.float32),
            mlp_norm=tensor(f"{base}.post_attention_layernorm.weight",
                            torch.float32))
        for ours, hf in _HF_PROJ.items():
            fields[ours] = lin(f"{base}.{hf}")
        layers.append(LayerParams(**fields))

    lm_head = None
    if not config.tie_word_embeddings and "lm_head.weight" in state:
        lm_head = DenseLinear(w=tensor("lm_head.weight", dtype))
    return ModelParams(
        embed=tensor("embed_tokens.weight", dtype), layers=layers,
        final_norm=tensor("norm.weight", torch.float32), lm_head=lm_head)


def load_hf_checkpoint(path: str, dtype=None,
                       device="cuda") -> Tuple[ModelParams, ModelConfig]:
    """Load a local HF checkpoint directory onto ``device``."""
    with open(os.path.join(path, "config.json")) as f:
        config = config_from_hf(json.load(f))
    state = _load_state_dict(path)
    return params_from_state_dict(state, config, dtype, device), config
