"""Checkpoints of (possibly compressed) model params, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.utils.
checkpoint``, in the same format, so either package reads what the other
writes: a directory with ``params.npz`` (every array, keyed by its path:
``embed``, ``layers.{i}.{field}[.{leaf}]``, ``lm_head.{leaf}``) and
``manifest.json`` (the model config, each linear's kind and static fields,
and each array's dtype). bf16 arrays are stored as f32 with the dtype tag
``"bfloat16"``; an e8p linear stores its 2-bit lattice codes (uint16, one
per 8 weights), rebuilt to the int4 serving pack at load. The npz is
written uncompressed (the reference deflates it; ``np.load`` reads both,
and deflating a 7B-width embedding takes longer than writing it).

The dtype table is built per call (the reference keeps it in a module
global, ROADMAP.md caveat R11).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    LayerParams, ModelParams)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import lattice

_LAYER_FIELDS = tuple(f.name for f in dataclasses.fields(LayerParams))


class _Writer:
    """Arrays and their dtype tags for one save."""

    def __init__(self):
        self.arrays: Dict[str, np.ndarray] = {}
        self.dtypes: Dict[str, str] = {}

    def put(self, key: str, value) -> None:
        """Store a tensor (bf16 as f32 tagged "bfloat16") or an array."""
        if isinstance(value, torch.Tensor):
            t = value.detach().cpu()
            if t.dtype == torch.bfloat16:
                self.arrays[key] = t.float().numpy()
                self.dtypes[key] = "bfloat16"
                return
            value = t.numpy()
        self.arrays[key], self.dtypes[key] = value, str(value.dtype)

    def linear(self, lin, prefix: str) -> dict:
        if isinstance(lin, DenseLinear):
            self.put(f"{prefix}.w", lin.w)
            if lin.b is not None:
                self.put(f"{prefix}.b", lin.b)
            return {"kind": "dense", "has_bias": lin.b is not None}
        if not isinstance(lin, CalderaLinear):
            raise TypeError(f"cannot checkpoint a {type(lin).__name__} at "
                            f"{prefix}")
        if lin.q_method == "e8p":
            codes = lattice.int4_planes_to_codes(lin.packed)
            self.put(f"{prefix}.e8p_codes",
                     codes.cpu().numpy().astype(np.uint16))
        else:
            self.put(f"{prefix}.packed", lin.packed)
        for name in ("scales", "L", "R", "global_scale"):
            self.put(f"{prefix}.{name}", getattr(lin, name))
        if lin.b is not None:
            self.put(f"{prefix}.b", lin.b)
        return {"kind": "caldera", "has_bias": lin.b is not None,
                "num_bits": lin.num_bits, "group_size": lin.group_size,
                "out_features": lin.out_features,
                "in_features": lin.in_features, "mode": lin.mode,
                "q_method": lin.q_method}


def save_params(path: str, params: ModelParams, config: ModelConfig) -> None:
    """Write ``params`` (dense or CALDERA linears, bf16 factors) and
    ``config`` to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    w = _Writer()
    w.put("embed", params.embed)
    w.put("final_norm", params.final_norm)
    manifest: dict = {"config": dataclasses.asdict(config),
                      "num_layers": len(params.layers), "layers": [],
                      "has_lm_head": params.lm_head is not None}
    for i, lp in enumerate(params.layers):
        layer_meta = {}
        for name in _LAYER_FIELDS:
            prefix = f"layers.{i}.{name}"
            if name.endswith("_norm"):
                w.put(prefix, getattr(lp, name))
                layer_meta[name] = {"kind": "array"}
            else:
                layer_meta[name] = w.linear(getattr(lp, name), prefix)
        manifest["layers"].append(layer_meta)
    if params.lm_head is not None:
        manifest["lm_head"] = w.linear(params.lm_head, "lm_head")
    manifest["dtypes"] = w.dtypes
    np.savez(os.path.join(path, "params.npz"), **w.arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_params(path: str, device="cuda") -> Tuple[ModelParams, ModelConfig]:
    """Read a checkpoint written by :func:`save_params` (or the reference's)
    onto ``device``."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    config = ModelConfig(**manifest["config"])
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(path, "params.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def get(key):
        a = arrays[key]
        t = torch.from_numpy(np.array(a)).to(dev)      # keeps 0-d arrays
        return t.to(torch.bfloat16) if dtypes.get(key) == "bfloat16" else t

    def linear(meta, prefix):
        b = get(f"{prefix}.b") if meta["has_bias"] else None
        if meta["kind"] == "dense":
            return DenseLinear(w=get(f"{prefix}.w"), b=b)
        q_method = meta.get("q_method", "uniform")
        if q_method == "e8p":
            codes = arrays[f"{prefix}.e8p_codes"].astype(np.int32)
            packed = lattice.codes_to_int4_planes(
                torch.from_numpy(codes).to(dev), meta["in_features"])
        else:
            packed = get(f"{prefix}.packed")
        return CalderaLinear(
            packed=packed, scales=get(f"{prefix}.scales"),
            L=get(f"{prefix}.L"), R=get(f"{prefix}.R"),
            global_scale=get(f"{prefix}.global_scale"), b=b,
            num_bits=meta["num_bits"], group_size=meta["group_size"],
            out_features=meta["out_features"],
            in_features=meta["in_features"],
            mode=meta.get("mode", "grouped"), q_method=q_method)

    layers = []
    for i, layer_meta in enumerate(manifest["layers"]):
        fields = {}
        for name in _LAYER_FIELDS:
            prefix = f"layers.{i}.{name}"
            meta = layer_meta[name]
            fields[name] = (get(prefix) if meta["kind"] == "array"
                            else linear(meta, prefix))
        layers.append(LayerParams(**fields))
    lm_head = (linear(manifest["lm_head"], "lm_head")
               if manifest["has_lm_head"] else None)
    return ModelParams(embed=get("embed"), layers=layers,
                       final_norm=get("final_norm"), lm_head=lm_head), config
