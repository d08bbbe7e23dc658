"""Quantization-aware training of CALDERA-compressed models (STE), in
PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.qat``:
unpack each packed :class:`compressed.CalderaLinear` into a trainable
:class:`compressed.QATLinear` (dequantized in f32), fine-tune with
:func:`models.train.train_step` (``ste_quantize`` passes gradients
straight through its rounding), then re-pack. The fake-quant grid is the
serving packers' symmetric absmax grid, so finalizing a prepared model
re-packs the same codes under the same scale.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.models import train
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, QATLinear, compress_linear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    LayerParams, ModelParams)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K


def prepare_qat_linear(lin: CalderaLinear) -> QATLinear:
    """A serving CalderaLinear as a trainable QATLinear: codes dequantized
    in f32 (not through the bf16 serving dequant), so grid points quantize
    back to the same codes."""
    maxq = 2 ** (lin.num_bits - 1) - 1
    q = K.unpack_codes(lin.packed, lin.num_bits).float() - maxq
    if lin.mode == "w4a8":
        Wq = q * lin.scales                          # (N, 1) row scales
        group = None
    else:
        G = q.shape[1] // lin.scales.shape[1]
        Wq = q * lin.scales.repeat_interleave(G, dim=1)
        group = lin.group_size
    L, R = lin.factors()
    return QATLinear(Wq=Wq, L=L.float(), R=R.float(),
                     global_scale=lin.global_scale.float().clone(),
                     b=lin.b, num_bits=lin.num_bits, group_size=group,
                     mode=lin.mode)


def finalize_qat_linear(lin: QATLinear) -> CalderaLinear:
    """Re-pack a trained QATLinear into serving form (the same absmax grid
    as its fake-quant forward)."""
    return compress_linear(
        lin.Wq, lin.L, lin.R, lin.num_bits,
        global_scale=float(lin.global_scale),
        group_size=lin.group_size, bias=lin.b, mode=lin.mode)


def _map_linears(params: ModelParams, fn, match) -> ModelParams:
    layers = []
    for lp in params.layers:
        fields = {}
        for f in dataclasses.fields(LayerParams):
            lin = getattr(lp, f.name)
            fields[f.name] = fn(lin) if isinstance(lin, match) else lin
        layers.append(LayerParams(**fields))
    return ModelParams(embed=params.embed, layers=layers,
                       final_norm=params.final_norm,
                       lm_head=params.lm_head)


def prepare_qat_model(params: ModelParams) -> ModelParams:
    """CalderaLinear -> QATLinear across all layers; every tensor is copied,
    so training leaves the caller's params as they are."""
    out = _map_linears(params, prepare_qat_linear, CalderaLinear)
    return train.replace_leaves(out, {
        k: t.clone() for k, t in train.tensor_leaves(out).items()})


def finalize_qat_model(params: ModelParams) -> ModelParams:
    """QATLinear -> packed CalderaLinear across all layers."""
    return _map_linears(params, finalize_qat_linear, QATLinear)


def make_qat_optimizer(lr: float = 1e-5) -> train.AdamW:
    """AdamW over every floating leaf but the ``global_scale`` ones (their
    gradient is zero by construction; weight decay would still shrink
    them)."""
    return train.AdamW(lr=lr, frozen=("global_scale",))


def qat_finetune(params: ModelParams, tokens: torch.Tensor, config,
                 steps: int = 10, lr: float = 1e-5
                 ) -> Tuple[ModelParams, List[float]]:
    """Prepare, train ``steps`` on (B, S) ``tokens``, finalize. Returns
    (packed params, the losses)."""
    qp = prepare_qat_model(params)
    opt = make_qat_optimizer(lr)
    state = opt.init(qp)
    losses = []
    for _ in range(steps):
        qp, state, loss = train.train_step(qp, state, tokens, config, opt)
        losses.append(float(loss))
    return finalize_qat_model(qp), losses
