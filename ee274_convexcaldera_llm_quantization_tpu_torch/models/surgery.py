"""Model surgery: per-projection CALDERA compression of a transformer, in
PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.
surgery``: walk the model's projections, run CALDERA with each one's
Hessian on the weight's device, pack the result in serving layout
(``compressed.compress_linear``), and keep the dense weight where the
relative error exceeds the threshold. The serving form re-quantizes the
unquantized residual ``W / gs - L @ R`` on the serving grid, except under
LDLQ, whose Q is packed as it is (a re-rounding would discard the error
feedback).

Not ported yet: the servable Hadamard path (``use_hadamard="servable"``,
which needs ``compressed.RotatedLinear``, ROADMAP.md Queue A item 15) and
``compress_model_with_budget`` (``allocate/multigroup.py``, item 14); both
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.decomp.caldera import (
    CalderaParams, caldera)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    DenseLinear, compress_linear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    LayerParams, ModelParams)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj")
_LAYER_FIELDS = tuple(f.name for f in dataclasses.fields(LayerParams))


def _rel_error(W_hat: torch.Tensor, W: torch.Tensor) -> float:
    return float(torch.linalg.norm(W_hat - W) / torch.linalg.norm(W))


def _hessian_tensor(H, device) -> Optional[torch.Tensor]:
    if H is None:
        return None
    H = torch.as_tensor(H, dtype=torch.float32).to(device)
    return torch.diag(H) if H.dim() == 1 else H


def caldera_with_hadamard(caldera_params: CalderaParams, W: torch.Tensor,
                          H=None) -> Tuple[torch.Tensor, float]:
    """CALDERA in a two-sided Hadamard-rotated basis (incoherence
    processing): pad ``W`` to powers of two, rotate ``H1 W H2`` (FWHTs),
    decompose there with the Hessian rotated as ``H2^T H_pad H2`` (padding
    with the identity), rotate the reconstruction back. Returns ``(W_hat,
    relative_error)``; like the reference, the result is dense."""
    m, n = W.shape
    Wr, m2, n2 = K.hadamard_sandwich(W.float())
    H = _hessian_tensor(H, W.device)
    Hr = None
    if H is not None:
        Hp = torch.zeros((n2, n2), dtype=torch.float32, device=W.device)
        Hp[:n, :n] = H
        idx = torch.arange(n, n2, device=W.device)
        Hp[idx, idx] = 1.0
        Hr = K.fwht(K.fwht(Hp, axis=0), axis=1) / torch.tensor(
            float(n2), dtype=torch.float32, device=W.device)
        Hr = (Hr + Hr.T) / 2
    decomp = caldera(caldera_params, Wr, H=Hr, scale_W=False)
    W_hat = K.hadamard_unsandwich(decomp.reconstruct(), m, n)
    return W_hat, _rel_error(W_hat, W)


@dataclasses.dataclass
class SurgeryReport:
    """Per-projection compression outcomes."""

    errors: Dict[str, float] = dataclasses.field(default_factory=dict)
    skipped: List[str] = dataclasses.field(default_factory=list)
    compressed: List[str] = dataclasses.field(default_factory=list)
    total_bits: int = 0
    total_params: int = 0

    @property
    def avg_bits_per_param(self) -> float:
        return self.total_bits / max(self.total_params, 1)


def _packed_bits(m: int, n: int, rank: int, qbits: int, e8p: bool) -> int:
    """Codes, bf16 factors and, for e8p, one fp16 scale per row."""
    return m * n * qbits + rank * (m + n) * 16 + (m * 16 if e8p else 0)


def _q_source(cp: CalderaParams, W: torch.Tensor, Q, L, R,
              global_scale) -> torch.Tensor:
    """What the serving pack quantizes: the residual ``W / gs - L @ R``, or
    the solver's Q under LDLQ (or when Q was not computed)."""
    if cp.compute_quantized_component and cp.q_update != "ldlq":
        return W / global_scale - L @ R
    return Q


def _gate(report: SurgeryReport, name: str, err: float, threshold: float,
          progress) -> bool:
    """Record ``err``; True if the projection passes the quality gate (an
    error that is not a number fails it, where the reference's ``err >
    threshold`` test would pass it)."""
    report.errors[name] = err
    if progress is not None:
        progress(name, err)
    keep = err <= threshold
    (report.compressed if keep else report.skipped).append(name)
    return keep


def compress_model(
    params: ModelParams,
    caldera_params: CalderaParams,
    hessians: Optional[Dict] = None,
    layer_range: Optional[Tuple[int, int]] = None,
    proj_filter: Sequence[str] = PROJ_NAMES,
    error_threshold: float = 0.99,
    min_dim: int = 0,
    serving_bits: Optional[int] = None,
    serving_mode: str = "grouped",
    use_hadamard=False,
    serving_quant: str = "uniform",
    progress: Optional[Callable[[str, float], None]] = None,
) -> Tuple[ModelParams, SurgeryReport]:
    """Compress the selected projections of a model, each on its weight's
    device.

    ``hessians`` maps ``"layers.{i}.{proj}"`` to a diagonal (1-D) or full
    (2-D) input second moment (numpy or tensor); missing entries mean the
    identity. ``layer_range`` is an inclusive block range; ``min_dim``
    skips projections with a dimension at or below it. ``serving_bits``
    overrides the packed bit width (default ``caldera_params.Q_bits``);
    ``serving_mode`` "grouped" or "w4a8"; ``serving_quant="e8p"`` packs each
    residual with the E8P lattice (w4a8 only), counted at 2 bits plus one
    fp16 scale per row. ``use_hadamard=True`` decomposes in a Hadamard-
    rotated basis and keeps the dense reconstruction.
    """
    if use_hadamard == "servable":
        raise NotImplementedError(
            "use_hadamard='servable' needs compressed.RotatedLinear, which "
            "is not ported yet (ROADMAP.md, Queue A item 15)")
    report = SurgeryReport()
    sbits = serving_bits or caldera_params.Q_bits
    e8p = serving_quant == "e8p"
    new_layers = []
    for i, lp in enumerate(params.layers):
        in_range = layer_range is None or (
            layer_range[0] <= i <= layer_range[1])
        fields = {}
        for proj in _LAYER_FIELDS:
            lin = getattr(lp, proj)
            fields[proj] = lin
            if (proj not in proj_filter or not in_range
                    or not isinstance(lin, DenseLinear)):
                continue
            W = lin.w.float()
            m, n = W.shape
            name = f"layers.{i}.{proj}"
            if min(m, n) <= min_dim:
                continue
            H = None
            if hessians is not None and name in hessians:
                H = _hessian_tensor(hessians[name], W.device)
            report.total_params += m * n
            if use_hadamard:
                W_hat, err = caldera_with_hadamard(caldera_params, W, H=H)
                if _gate(report, name, err, error_threshold, progress):
                    fields[proj] = DenseLinear(w=W_hat.to(lin.w.dtype),
                                               b=lin.b)
                report.total_bits += m * n * 16
                continue
            decomp = caldera(caldera_params, W, H=H, scale_W=False)
            clin = compress_linear(
                _q_source(caldera_params, W, decomp.Q, decomp.L, decomp.R,
                          decomp.global_scale),
                decomp.L, decomp.R, sbits, global_scale=decomp.global_scale,
                bias=lin.b, mode=serving_mode, q_method=serving_quant)
            if _gate(report, name, _rel_error(clin.materialize(), W),
                     error_threshold, progress):
                fields[proj] = clin
                report.total_bits += _packed_bits(
                    m, n, decomp.L.shape[1], 2 if e8p else sbits, e8p)
            else:
                report.total_bits += m * n * 16
        new_layers.append(LayerParams(**fields))
    return ModelParams(embed=params.embed, layers=new_layers,
                       final_norm=params.final_norm,
                       lm_head=params.lm_head), report


def compress_model_batched(
    params: ModelParams,
    caldera_params: CalderaParams,
    hessians: Optional[Dict] = None,
    layer_range: Optional[Tuple[int, int]] = None,
    proj_filter: Sequence[str] = PROJ_NAMES,
    error_threshold: float = 0.99,
    serving_bits: Optional[int] = None,
    serving_mode: str = "grouped",
    progress: Optional[Callable[[str, float], None]] = None,
) -> Tuple[ModelParams, SurgeryReport]:
    """The reference's batched entry point (one vmapped solve per
    projection type on a TPU). The port's solves run one after another on
    the card either way, so this is :func:`compress_model` with the same
    arguments."""
    return compress_model(
        params, caldera_params, hessians=hessians, layer_range=layer_range,
        proj_filter=proj_filter, error_threshold=error_threshold,
        serving_bits=serving_bits, serving_mode=serving_mode,
        progress=progress)


def compress_model_with_budget(*args, **kwargs):
    """Mixed-precision surgery under a global bit budget: not ported yet."""
    raise NotImplementedError(
        "compress_model_with_budget needs allocate/multigroup.py, which is "
        "not ported yet (ROADMAP.md, Queue A item 14)")


def hessian_key_map_from_reference(torch_state_keys: Sequence[str]
                                   ) -> Dict[str, str]:
    """Map ``diag_Hessians.pt`` keys (``...layers.17.self_attn.q_proj``,
    ``...layers.17.mlp.down_proj``) to ``layers.{i}.{proj}``."""
    out = {}
    for key in torch_state_keys:
        parts = key.split(".")
        if "layers" not in parts:
            continue
        li = parts[parts.index("layers") + 1]
        if parts[-1] in PROJ_NAMES:
            out[key] = f"layers.{li}.{parts[-1]}"
    return out
