"""Layer-stacked model parameters, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.stacked``:
every projection's tensors carry a leading layer axis, and a layer is an
index into them (a view, never a copy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K


@dataclasses.dataclass
class LayerParams:
    """One transformer block's params; stacked, each leaf has a leading
    layer axis."""
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
class StackedModelParams:
    embed: torch.Tensor
    layers: LayerParams          # leaves stacked: leading axis = num_layers
    final_norm: torch.Tensor
    lm_head: Optional[object]


def _low_rank_layer(lin: CalderaLinear, l: int, y: torch.Tensor):
    """Low-rank contribution ``y @ (L[l] @ R[l]).T`` for a stacked
    CalderaLinear (bf16 or int8 factors)."""
    return K.low_rank_matmul(
        y, lin.L[l], lin.R[l],
        None if lin.L_scale is None else lin.L_scale[l],
        None if lin.R_scale is None else lin.R_scale[l])
