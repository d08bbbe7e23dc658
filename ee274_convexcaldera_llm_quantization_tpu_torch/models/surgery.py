"""Model surgery: per-projection CALDERA compression of a transformer, in
PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.
surgery``: walk the model's projections, run CALDERA with each one's
Hessian on the weight's device, pack the result in serving layout
(``compressed.compress_linear``), and keep the dense weight where the
relative error exceeds the threshold. The serving form re-quantizes the
unquantized residual ``W / gs - L @ R`` on the serving grid, except under
LDLQ, whose Q is packed as it is (a re-rounding would discard the error
feedback). ``use_hadamard="servable"`` keeps a Hadamard-rotated
decomposition packed (``compressed.RotatedLinear``);
:func:`compress_model_with_budget` assigns each projection its bits from a
menu under a global budget (``allocate.multigroup``) first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.allocate.multigroup \
    import GroupSpec, allocate_bits_discrete
from ee274_convexcaldera_llm_quantization_tpu_torch.decomp.caldera import (
    CalderaParams, caldera)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    DenseLinear, RotatedLinear, compress_linear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    LayerParams, ModelParams)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K
from ee274_convexcaldera_llm_quantization_tpu_torch.quant.quantizers import (
    QuantizerFactory)

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


def _rotate_hessian(H: Optional[torch.Tensor], n: int
                    ) -> Optional[torch.Tensor]:
    """``H' = H2 H H2`` of an (n, n) ``H`` for the orthonormal Hadamard H2
    (the rotated weight's inputs are ``H2 x``)."""
    if H is None:
        return None
    Hr = K.fwht(K.fwht(H, axis=0), axis=1) / torch.tensor(
        float(n), dtype=torch.float32, device=H.device)
    return (Hr + Hr.T) / 2


def compress_linear_rotated(caldera_params: CalderaParams, W: torch.Tensor,
                            H=None, serving_bits: Optional[int] = None,
                            serving_mode: str = "grouped",
                            bias: Optional[torch.Tensor] = None,
                            q_method: str = "uniform"
                            ) -> Tuple[RotatedLinear, float]:
    """CALDERA in a Hadamard-rotated basis, kept packed for rotated serving
    (:class:`compressed.RotatedLinear`): each side whose dimension is a
    power of two is rotated (no padding), the Hessian with the input side;
    the residual is packed as in :func:`compress_model`. Returns
    ``(RotatedLinear, relative_error)``, the error in the original
    basis."""
    m, n = W.shape
    rot_out = (m & (m - 1)) == 0
    rot_in = (n & (n - 1)) == 0
    Wf = W.float()
    Wr = Wf
    if rot_out:
        Wr = K.fwht(Wr, axis=0) / K._sqrt_size(m, 1, W.device)
    if rot_in:
        Wr = K.fwht(Wr, axis=1) / K._sqrt_size(n, 1, W.device)
    H = _hessian_tensor(H, W.device)
    Hr = _rotate_hessian(H, n) if rot_in else H
    inner, _, _ = _compress_projection(
        caldera_params, Wr, Hr, serving_bits or caldera_params.Q_bits, None,
        serving_mode, q_method)
    rl = RotatedLinear(inner=inner, b=bias, rot_in=rot_in, rot_out=rot_out)
    return rl, _rel_error(rl.materialize(), Wf)


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


def _compress_projection(cp: CalderaParams, W: torch.Tensor, H, bits: int,
                         bias, mode: str, q_method: str):
    """CALDERA of ``W`` and its serving pack at ``bits``; returns (the
    CalderaLinear, its relative error, the solver's rank)."""
    decomp = caldera(cp, W, H=H, scale_W=False)
    clin = compress_linear(
        _q_source(cp, W, decomp.Q, decomp.L, decomp.R, decomp.global_scale),
        decomp.L, decomp.R, bits, global_scale=decomp.global_scale,
        bias=bias, mode=mode, q_method=q_method)
    return clin, _rel_error(clin.materialize(), W), decomp.L.shape[1]


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
    rotated basis and keeps the dense reconstruction; ``"servable"`` keeps
    it packed as a :class:`compressed.RotatedLinear`
    (:func:`compress_linear_rotated`).
    """
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
            if use_hadamard and use_hadamard != "servable":
                W_hat, err = caldera_with_hadamard(caldera_params, W, H=H)
                if _gate(report, name, err, error_threshold, progress):
                    fields[proj] = DenseLinear(w=W_hat.to(lin.w.dtype),
                                               b=lin.b)
                report.total_bits += m * n * 16
                continue
            if use_hadamard == "servable":
                # the rank counts the e8p offset column, as the reference's
                new, err = compress_linear_rotated(
                    caldera_params, W, H=H, serving_bits=sbits,
                    serving_mode=serving_mode, bias=lin.b,
                    q_method=serving_quant)
                rank = new.inner.L.shape[1]
            else:
                new, err, rank = _compress_projection(
                    caldera_params, W, H, sbits, lin.b, serving_mode,
                    serving_quant)
            if _gate(report, name, err, error_threshold, progress):
                fields[proj] = new
                report.total_bits += _packed_bits(
                    m, n, rank, 2 if e8p else sbits, e8p)
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


def _mean_diag(H) -> float:
    H = torch.as_tensor(H)
    return float((H if H.dim() == 1 else torch.diagonal(H)).double().mean())


def compress_model_with_budget(
    params: ModelParams,
    caldera_params: CalderaParams,
    B_tot: float,
    hessians: Optional[Dict] = None,
    menu: Sequence[int] = (2, 4, 8),
    layer_range: Optional[Tuple[int, int]] = None,
    proj_filter: Sequence[str] = PROJ_NAMES,
    error_threshold: float = 0.99,
    serving_mode: str = "grouped",
    use_e8p_at_2bit: bool = False,
    progress: Optional[Callable[[str, float], None]] = None,
):
    """Mixed-precision surgery under a global bit budget ``B_tot`` (bits per
    parameter of the quantized components).

    Each selected projection is an allocation group with ``c = 0.1 Var(W)``
    and, as its distortion weight, the mean diagonal of its Hessian (1
    without one); :func:`allocate.multigroup.allocate_bits_discrete` picks
    each one's ``Q_bits`` from ``menu``, then CALDERA runs at that width.
    ``use_e8p_at_2bit`` puts every 2-bit group on the E8P lattice (w4a8
    only). The factors' bits come on top of the budget and are counted in
    the report. Returns ``(params, report, allocation)``.
    """
    specs = []
    for i, lp in enumerate(params.layers):
        if layer_range is not None and not (
                layer_range[0] <= i <= layer_range[1]):
            continue
        for proj in proj_filter:
            lin = getattr(lp, proj)
            if not isinstance(lin, DenseLinear):
                continue
            name = f"layers.{i}.{proj}"
            weight = 1.0
            if hessians is not None and name in hessians:
                weight = _mean_diag(hessians[name])
            W = lin.w.float()
            specs.append(GroupSpec(
                name=name, num_params=W.numel(),
                c=0.1 * float(W.double().var(unbiased=False)), k=1.0,
                weight=max(weight, 1e-12)))
    allocation = allocate_bits_discrete(specs, B_tot, menu=menu)

    report = SurgeryReport()
    new_layers = []
    for i, lp in enumerate(params.layers):
        fields = {}
        for proj in _LAYER_FIELDS:
            lin = getattr(lp, proj)
            fields[proj] = lin
            name = f"layers.{i}.{proj}"
            if name not in allocation.bits or not isinstance(lin,
                                                             DenseLinear):
                continue
            bits = int(allocation.bits[name])
            e8p_here = use_e8p_at_2bit and bits == 2
            if e8p_here and serving_mode != "w4a8":
                raise ValueError("use_e8p_at_2bit requires "
                                 "serving_mode='w4a8'")
            cp = dataclasses.replace(caldera_params, Q_bits=bits)
            if e8p_here:
                cp = dataclasses.replace(cp, quant_factory_Q=QuantizerFactory(
                    method="e8p", block_size="global"))
            W = lin.w.float()
            m, n = W.shape
            H = None
            if hessians is not None and name in hessians:
                H = _hessian_tensor(hessians[name], W.device)
            clin, err, _ = _compress_projection(
                cp, W, H, 4 if e8p_here else bits, lin.b, serving_mode,
                "e8p" if e8p_here else "uniform")
            report.total_params += m * n
            if _gate(report, name, err, error_threshold, progress):
                fields[proj] = clin
                # the rank counts the e8p offset column, as the reference's
                report.total_bits += (m * n * bits
                                      + clin.L.shape[1] * (m + n) * 16)
            else:
                report.total_bits += m * n * 16
        new_layers.append(LayerParams(**fields))
    return ModelParams(embed=params.embed, layers=new_layers,
                       final_norm=params.final_norm,
                       lm_head=params.lm_head), report, allocation


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
