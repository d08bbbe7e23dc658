"""Hessian (input-activation second moment) calibration, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.calibrate.
hessian``: a tapped forward pass (the port's ``llama`` pieces, every
projection through ``models.compressed.apply_linear``) takes the inputs of
each target projection and accumulates ``sum x x^T`` (full) or ``sum
x^2`` (diagonal) over the calibration batches, normalized once at the end
by the number of token positions. Each batch's sums are f32 products on
the params' device; the running totals are float64 there (the reference
adds the same f32 batch sums in float64 on the host).

Keys follow ``layers.{i}.{proj}``, the schema ``models.surgery.
compress_model`` reads. q/k/v share one input, as do gate/up: their
moments are computed once and stored under each name.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.surgery import (
    hessian_key_map_from_reference)

# input -> the projections that read it
_TAPS = {"attn_in": ("q_proj", "k_proj", "v_proj"), "o_in": ("o_proj",),
         "mlp_in": ("gate_proj", "up_proj"), "down_in": ("down_proj",)}


def _moment(acts: torch.Tensor, diag: bool) -> torch.Tensor:
    a = acts.reshape(-1, acts.shape[-1]).float()
    return (a * a).sum(dim=0) if diag else a.T @ a


def _tapped_forward(params: llama.ModelParams, tokens: torch.Tensor,
                    config: ModelConfig, diag: bool):
    """Forward pass over ``tokens`` (B, S) returning ``{(layer, tap):
    moment}`` for the four projection inputs of each layer."""
    B, S = tokens.shape
    x = params.embed[tokens].float()
    cos, sin = llama.rope_tables(config,
                                 torch.arange(S, device=tokens.device)[None])
    mask = llama._causal(S, tokens.device)
    stats = {}
    for i, lp in enumerate(params.layers):
        lin = llama._linears(lp)
        y = llama.rms_norm(x, lp.attn_norm, config.rms_norm_eps)
        stats[i, "attn_in"] = _moment(y, diag)
        q, k, v = llama._project_qkv(lin, y, config, cos, sin)
        attn = llama._attention(q, k, v, mask).reshape(B, S, config.q_dim)
        stats[i, "o_in"] = _moment(attn, diag)
        x = x + lin("o_proj", attn)
        y = llama.rms_norm(x, lp.mlp_norm, config.rms_norm_eps)
        stats[i, "mlp_in"] = _moment(y, diag)
        gate, up = lin("gate_proj", y), lin("up_proj", y)
        h = gate * torch.sigmoid(gate) * up
        stats[i, "down_in"] = _moment(h, diag)
        x = x + lin("down_proj", h)
    return stats


def collect_hessians(params: llama.ModelParams, token_batches,
                     config: ModelConfig,
                     diag: bool = True) -> Dict[str, torch.Tensor]:
    """Projection-input second moments over calibration batches.

    ``token_batches``: iterable of (B, S) integer arrays or tensors, moved
    to the params' device. Returns ``{"layers.{i}.{proj}": H}``, float64 on
    that device, ``H = (1/N) sum x x^T`` (or its diagonal) over all N token
    positions.
    """
    dev = params.embed.device
    resolve_device(dev)
    totals: Dict[tuple, torch.Tensor] = {}
    n_total = 0
    for tokens in token_batches:
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64).to(
            dev)
        n_total += tokens.numel()
        for key, acc in _tapped_forward(params, tokens, config,
                                        diag).items():
            if key in totals:
                totals[key] += acc.double()
            else:
                totals[key] = acc.double()
    out = {}
    for (i, tap), acc in totals.items():
        H = acc / max(n_total, 1)
        for j, proj in enumerate(_TAPS[tap]):
            out[f"layers.{i}.{proj}"] = H if j == 0 else H.clone()
    return out


def save_hessians(path: str, hessians) -> None:
    """Write the calibration artifact as an npz (float64 arrays)."""
    np.savez_compressed(path, **{k: torch.as_tensor(v).cpu().numpy()
                                 for k, v in hessians.items()})


def load_hessians(path: str) -> Dict[str, np.ndarray]:
    """Read :func:`save_hessians`' npz, or a reference-format ``.pt``."""
    if path.endswith(".pt"):
        return load_reference_hessians(path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_reference_hessians(path: str) -> Dict[str, np.ndarray]:
    """Load a ``diag_Hessians.pt`` (a torch pickle of ``{module_path:
    tensor}``, read with ``weights_only=True``) and remap its language-tower
    keys to ``layers.{i}.{proj}``."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    key_map = hessian_key_map_from_reference(
        [k for k in raw.keys() if "language_model" in k
         or k.startswith("model.layers")])
    return {new: raw[old].float().numpy().astype(np.float64)
            for old, new in key_map.items()}
