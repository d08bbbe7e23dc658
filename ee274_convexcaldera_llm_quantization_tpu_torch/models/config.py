"""Model configurations for the Llama/Qwen2 transformer family.

Covers the reference's target model (the language tower of
LLaVA-OneVision-Qwen2-0.5B — Qwen2 architecture with attention bias and
GQA, reference ``main.py:261-266`` / ``diag_Hessians.pt`` schema in
SURVEY.md section 2.9) and the BASELINE.json north-star models
(Llama-2-7B / 13B).

A copy of ``ee274_convexcaldera_llm_quantization_tpu.models.config``: the
port keeps its own so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32          # < num_heads => grouped-query attention
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 4096
    attention_bias: bool = False    # True for Qwen2 q/k/v projections
    tie_word_embeddings: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


LLAMA2_7B = ModelConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008,
    num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
    max_seq_len=4096)

LLAMA2_13B = ModelConfig(
    vocab_size=32000, hidden_size=5120, intermediate_size=13824,
    num_layers=40, num_heads=40, num_kv_heads=40, head_dim=128,
    max_seq_len=4096)

# Llama-3-8B-shaped: grouped-query attention (8 kv heads, kv_groups=4)
# and a 128k vocab — exercises the G>1 flash-attention path and the
# vocab-heavy int8 head at serving scale.
LLAMA3_8B = ModelConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    rope_theta=500000.0, max_seq_len=8192)

# Language tower of llava-hf/llava-onevision-qwen2-0.5b-ov-hf: Qwen2-0.5B
# (hidden 896, 24 layers, 14 heads / 2 KV heads, MLP 4864, qkv bias) —
# matches the diag_Hessians.pt layer inventory (SURVEY.md section 2.9).
QWEN2_0_5B = ModelConfig(
    vocab_size=151936, hidden_size=896, intermediate_size=4864,
    num_layers=24, num_heads=14, num_kv_heads=2, head_dim=64,
    rope_theta=1000000.0, rms_norm_eps=1e-6, max_seq_len=32768,
    attention_bias=True, tie_word_embeddings=True)

# Tiny config for tests: same topology as Llama, shapes aligned to TPU
# tiling (multiples of 128 where it matters for the packed kernels).
TINY = ModelConfig(
    vocab_size=256, hidden_size=128, intermediate_size=256,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
    max_seq_len=128)

# Tiny MHA config satisfying the persistent whole-layer kernel's support
# constraints (MHA, head_dim 128, lane-aligned hidden/intermediate): lets
# the megastep kernel be tested in interpret mode and chip-smoked at a
# small scale.
TINY_MHA = ModelConfig(
    vocab_size=256, hidden_size=512, intermediate_size=1024,
    num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
    max_seq_len=256)

PRESETS = {
    "llama2-7b": LLAMA2_7B,
    "llama2-13b": LLAMA2_13B,
    "llama3-8b": LLAMA3_8B,
    "qwen2-0.5b": QWEN2_0_5B,
    "tiny": TINY,
    "tiny-mha": TINY_MHA,
}
