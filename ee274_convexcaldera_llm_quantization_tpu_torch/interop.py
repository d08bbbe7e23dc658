"""Load fused W4A8 params handed over as numpy arrays.

The reference package's ``FusedStackedParams`` flattens to a dict of numpy
arrays keyed by attribute path (``"embed"``, ``"layers.qkv.packed"``,
``"layers.qkv.Ls.0"``, ``"layers.o_proj.L_scale"``, ``"lm_head.w8"``, ...)
plus a dict of its static fields under the same paths (``"layers.qkv.
num_bits"``, ``"layers.qkv.splits"``, ``"layers.o_proj.mode"``, ...).
Bytes are taken as they are; bfloat16 arrays (numpy's ``bfloat16``
extension dtype) are reinterpreted bit for bit.
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
    if (f"{p}.L_cat" in arrays
            or meta.get(f"{p}.factor_kernel", "xla") != "xla"):
        raise NotImplementedError(
            "N-concatenated L factors (factor paths 'l'/'lr') are not "
            "ported yet (ROADMAP.md, Queue B items 10-11)")
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
        num_bits=int(meta[f"{p}.num_bits"]),
        splits=tuple(int(s) for s in meta[f"{p}.splits"]),
        ranks=tuple(int(r) for r in meta[f"{p}.ranks"]))


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


def _head(arrays, device):
    if "lm_head.w8" in arrays:
        return Int8Linear(w8=_tensor(arrays["lm_head.w8"], device),
                          scales=_tensor(arrays["lm_head.scales"], device),
                          b=_opt(arrays, "lm_head.b", device))
    if "lm_head.w" in arrays:
        return DenseLinear(w=_tensor(arrays["lm_head.w"], device),
                           b=_opt(arrays, "lm_head.b", device))
    return None


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
                              lm_head=_head(arrays, dev))
