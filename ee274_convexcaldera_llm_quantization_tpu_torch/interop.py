"""Load model params handed over as numpy arrays.

The reference package's params flatten to a dict of numpy arrays keyed by
attribute path plus a dict of their static fields under the same paths:

- ``FusedStackedParams``: ``"embed"``, ``"layers.qkv.packed"``,
  ``"layers.qkv.Ls.0"`` (or ``"layers.qkv.L_cat"`` on factor paths "l" and
  "lr"), ``"layers.o_proj.L_scale"``, ``"lm_head.w8"``, ... with
  ``"layers.qkv.num_bits"``, ``"layers.qkv.splits"``,
  ``"layers.qkv.factor_kernel"``, ...;
- per-layer ``ModelParams``: ``"layers.0.attn_norm"``,
  ``"layers.0.q_proj.packed"``, ``"layers.1.down_proj.w"``, ...;
- ``StackedModelParams``: ``"layers.attn_norm"``, ``"layers.q_proj.packed"``,
  ... (each tensor with its leading layer axis).

A projection or head is a ``DenseLinear`` (``w``), an ``Int8Linear``
(``w8``) or a ``CalderaLinear`` (``packed``; either serving mode, bf16 or
int8 factors); a missing ``lm_head.*`` is a tied head. Bytes are taken as
they are; bfloat16 arrays (numpy's ``bfloat16`` extension dtype) are
reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear, Int8Linear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.fused import (
    FusedLayerStack, FusedStackedParams, FusedW4A8Linear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    LayerParams, ModelParams)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.stacked import (
    StackedModelParams)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tuple(arrays, prefix: str, device):
    out = []
    while f"{prefix}.{len(out)}" in arrays:
        out.append(_tensor(arrays[f"{prefix}.{len(out)}"], device))
    return tuple(out)


def _opt(arrays, key: str, device):
    return _tensor(arrays[key], device) if key in arrays else None


def _fused_linear(arrays, meta, p: str, device) -> FusedW4A8Linear:
    L_scales = _tuple(arrays, f"{p}.L_scales", device)
    return FusedW4A8Linear(
        packed=_tensor(arrays[f"{p}.packed"], device),
        scales=_tensor(arrays[f"{p}.scales"], device),
        R=_tensor(arrays[f"{p}.R"], device),
        Ls=_tuple(arrays, f"{p}.Ls", device),
        global_scale=_tensor(arrays[f"{p}.global_scale"], device),
        b=_opt(arrays, f"{p}.b", device),
        R_scale=_opt(arrays, f"{p}.R_scale", device),
        L_scales=L_scales or None,
        L_cat=_opt(arrays, f"{p}.L_cat", device),
        L_scale_cat=_opt(arrays, f"{p}.L_scale_cat", device),
        num_bits=int(meta[f"{p}.num_bits"]),
        splits=tuple(int(s) for s in meta[f"{p}.splits"]),
        ranks=tuple(int(r) for r in meta[f"{p}.ranks"]),
        factor_kernel=str(meta.get(f"{p}.factor_kernel", "xla")))


def _caldera_linear(arrays, meta, p: str, device) -> CalderaLinear:
    return CalderaLinear(
        packed=_tensor(arrays[f"{p}.packed"], device),
        scales=_tensor(arrays[f"{p}.scales"], device),
        L=_tensor(arrays[f"{p}.L"], device),
        R=_tensor(arrays[f"{p}.R"], device),
        global_scale=_tensor(arrays[f"{p}.global_scale"], device),
        b=_opt(arrays, f"{p}.b", device),
        L_scale=_opt(arrays, f"{p}.L_scale", device),
        R_scale=_opt(arrays, f"{p}.R_scale", device),
        num_bits=int(meta[f"{p}.num_bits"]),
        group_size=int(meta[f"{p}.group_size"]),
        out_features=int(meta[f"{p}.out_features"]),
        in_features=int(meta[f"{p}.in_features"]),
        mode=str(meta[f"{p}.mode"]),
        q_method=str(meta.get(f"{p}.q_method", "uniform")),
        grid_bits=int(meta.get(f"{p}.grid_bits", 0)))


def _linear(arrays, meta, p: str, device):
    """The linear at path ``p``, or None when nothing is stored there."""
    if f"{p}.packed" in arrays:
        return _caldera_linear(arrays, meta, p, device)
    if f"{p}.w8" in arrays:
        return Int8Linear(w8=_tensor(arrays[f"{p}.w8"], device),
                          scales=_tensor(arrays[f"{p}.scales"], device),
                          b=_opt(arrays, f"{p}.b", device))
    if f"{p}.w" in arrays:
        return DenseLinear(w=_tensor(arrays[f"{p}.w"], device),
                           b=_opt(arrays, f"{p}.b", device))
    return None


def _layer_params(arrays, meta, p: str, device) -> LayerParams:
    return LayerParams(
        attn_norm=_tensor(arrays[f"{p}.attn_norm"], device),
        mlp_norm=_tensor(arrays[f"{p}.mlp_norm"], device),
        **{name: _linear(arrays, meta, f"{p}.{name}", device)
           for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                        "up_proj", "down_proj")})


def model_params_from_numpy(arrays: Mapping[str, np.ndarray],
                            meta: Mapping[str, object],
                            device="cuda") -> ModelParams:
    """Build the port's per-layer :class:`llama.ModelParams` on ``device``
    from the reference's ``ModelParams`` flattened to numpy (keys
    ``layers.<i>.<field>...``; see the module docstring)."""
    dev = resolve_device(device)
    n = 0
    while f"layers.{n}.attn_norm" in arrays:
        n += 1
    return ModelParams(
        embed=_tensor(arrays["embed"], dev),
        layers=[_layer_params(arrays, meta, f"layers.{i}", dev)
                for i in range(n)],
        final_norm=_tensor(arrays["final_norm"], dev),
        lm_head=_linear(arrays, meta, "lm_head", dev))


def stacked_params_from_numpy(arrays: Mapping[str, np.ndarray],
                              meta: Mapping[str, object],
                              device="cuda") -> StackedModelParams:
    """Build the port's :class:`stacked.StackedModelParams` on ``device``
    from the reference's ``StackedModelParams`` flattened to numpy (keys
    ``layers.<field>...``; see the module docstring)."""
    dev = resolve_device(device)
    return StackedModelParams(
        embed=_tensor(arrays["embed"], dev),
        layers=_layer_params(arrays, meta, "layers", dev),
        final_norm=_tensor(arrays["final_norm"], dev),
        lm_head=_linear(arrays, meta, "lm_head", dev))


def fused_params_from_numpy(arrays: Mapping[str, np.ndarray],
                            meta: Mapping[str, object],
                            device="cuda") -> FusedStackedParams:
    """Build the port's :class:`FusedStackedParams` on ``device`` from the
    reference's fused params flattened to numpy (see the module
    docstring). A missing optional key (``b``, ``R_scale``, ...) means
    None; a missing ``lm_head.*`` means a tied head."""
    dev = resolve_device(device)
    arrays: Dict[str, np.ndarray] = dict(arrays)
    layers = FusedLayerStack(
        attn_norm=_tensor(arrays["layers.attn_norm"], dev),
        qkv=_fused_linear(arrays, meta, "layers.qkv", dev),
        o_proj=_caldera_linear(arrays, meta, "layers.o_proj", dev),
        mlp_norm=_tensor(arrays["layers.mlp_norm"], dev),
        gateup=_fused_linear(arrays, meta, "layers.gateup", dev),
        down_proj=_caldera_linear(arrays, meta, "layers.down_proj", dev))
    return FusedStackedParams(embed=_tensor(arrays["embed"], dev),
                              layers=layers,
                              final_norm=_tensor(arrays["final_norm"], dev),
                              lm_head=_linear(arrays, meta, "lm_head", dev))
