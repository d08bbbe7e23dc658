"""SCL classical quantization baselines (scalar uniform, Lloyd-Max, K-means
vector quantization), in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.quant.scl``, on
the data's device. The reference's fixed points are ``lax.while_loop``s;
here they are plain loops with the same stopping rule (the change in
distortion below ``tolerance``, or ``max_iterations`` updates), factored
as :func:`lloyd_max_fixed_point` and :func:`kmeans_fixed_point` so that
both start from given centroids. Assignment is an argmin over the codebook
(first index on ties, as ``jnp.argmin``); the centroid sums are taken in
f64 (the reference's are one-hot f32 matmuls), so codebooks agree to f32
rounding. K-means draws its first centroids from a ``torch.Generator``
seeded with ``random_seed`` (the reference draws them with
``jax.random.choice``), so its centroids differ from the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SCLQuantizationParams:
    """Parameters (the reference's ``SCLQuantizationParams``)."""

    num_bits: int = 2
    method: str = "scalar"          # "scalar" | "lloyd_max" | "vector"
    vector_dim: int = 1
    max_iterations: int = 100
    tolerance: float = 1e-6
    random_seed: int = 42
    distortion_metric: str = "mse"  # "mse" | "mae"


@dataclasses.dataclass
class SCLQuantizationResult:
    quantized: torch.Tensor
    codebook: torch.Tensor
    indices: Optional[torch.Tensor]
    rate: float
    distortion: float
    compression_ratio: float
    num_codebook_entries: int
    method: str


# ---------------------------------------------------------------------------
# Scalar uniform
# ---------------------------------------------------------------------------

def scalar_quantize_uniform(data: torch.Tensor, num_bits: int):
    """Min/max range uniform quantization. Returns (quantized, codebook,
    indices).

    The step is ``(max - min)`` times ``f32(1 / (levels - 1))`` and each
    level ``min + i * step`` is rounded once (a fused multiply-add): the
    reference's compiled function computes them so."""
    data = data.float()
    lo, hi = data.min(), data.max()
    levels = 2 ** num_bits
    rcp = torch.tensor(1.0 / (levels - 1), dtype=torch.float32,
                       device=data.device)
    step = torch.clamp((hi - lo) * rcp, min=1e-12)
    idx = torch.clamp(torch.round((data - lo) / step), 0,
                      levels - 1).to(torch.int32)
    i = torch.arange(levels, dtype=torch.float64, device=data.device)
    codebook = (lo.double() + step.double() * i).float()
    return codebook[idx.long()], codebook, idx


# ---------------------------------------------------------------------------
# Lloyd-Max and K-means: one fixed point
# ---------------------------------------------------------------------------

def _fixed_point(points: torch.Tensor, centroids0: torch.Tensor, assign,
                 max_iterations: int, tolerance: float):
    """Generalized Lloyd iteration on ``points`` (n, d): assign each to a
    centroid, move each centroid to its cell's mean (an empty cell keeps
    its centroid), until the mean squared distortion changes by less than
    ``tolerance`` or ``max_iterations`` updates ran. Returns (centroids,
    distortion as an f32 0-d tensor)."""
    k = centroids0.shape[0]
    tol = float(np.float32(tolerance))

    def update(c):
        idx = assign(c)
        counts = torch.bincount(idx, minlength=k)
        sums = torch.zeros((k, points.shape[1]), dtype=torch.float64,
                           device=points.device).index_add_(
            0, idx, points.double())
        new = torch.where(counts[:, None] > 0,
                          (sums / counts.clamp_min(1)[:, None]).float(), c)
        return new, ((points - new[idx]) ** 2).mean()

    c, dist = update(centroids0)
    prev = torch.tensor(math.inf, dtype=torch.float32)
    it = 1
    while it < max_iterations and float((prev - dist.cpu()).abs()) >= tol:
        prev = dist.cpu()
        c, dist = update(c)
        it += 1
    return c, dist


def _assign_scalar(flat: torch.Tensor):
    return lambda c: torch.argmin((flat - c[None, :, 0]).abs(), dim=1)


def lloyd_max_fixed_point(flat: torch.Tensor, codebook0: torch.Tensor,
                          max_iterations: int = 100,
                          tolerance: float = 1e-6):
    """Lloyd-Max from ``codebook0`` (levels,) on f32 scalars ``flat`` (n,):
    nearest-level assignment, conditional means. Returns (codebook,
    distortion)."""
    c, dist = _fixed_point(flat[:, None], codebook0.float()[:, None],
                           _assign_scalar(flat[:, None]), max_iterations,
                           tolerance)
    return c[:, 0], dist


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(lo, hi, num)``: ``lo + i * ((hi - lo) / (num - 1))``
    below the end, ``hi`` at it."""
    delta = (hi - lo) / (num - 1)
    i = torch.arange(num - 1, dtype=torch.float32, device=lo.device)
    return torch.cat([lo + i * delta, hi[None]])


def lloyd_max(data: torch.Tensor, num_bits: int, max_iterations: int = 100,
              tolerance: float = 1e-6):
    """The optimal scalar MSE quantizer, uniformly initialized over
    [min, max]. Returns (quantized, codebook, indices, distortion)."""
    flat = data.reshape(-1).float()
    codebook, dist = lloyd_max_fixed_point(
        flat, _linspace(flat.min(), flat.max(), 2 ** num_bits),
        max_iterations, tolerance)
    idx = _assign_scalar(flat[:, None])(codebook[:, None])
    return (codebook[idx].reshape(data.shape), codebook,
            idx.reshape(data.shape), dist)


def _assign_vectors(vecs: torch.Tensor):
    v_sq = (vecs * vecs).sum(dim=1, keepdim=True)

    def assign(c):
        d = v_sq - 2.0 * (vecs @ c.T) + (c * c).sum(dim=1)[None, :]
        return torch.argmin(d, dim=1)
    return assign


def kmeans_fixed_point(vecs: torch.Tensor, centroids0: torch.Tensor,
                       max_iterations: int = 100, tolerance: float = 1e-6):
    """K-means (the generalized Lloyd iteration) on vectors (n, d) from
    ``centroids0`` (k, d); squared distances by the ``|x|^2 - 2 x.c +
    |c|^2`` expansion. Returns (centroids, distortion)."""
    return _fixed_point(vecs, centroids0.float(), _assign_vectors(vecs),
                        max_iterations, tolerance)


def _vectors(data: torch.Tensor, vector_dim: int) -> torch.Tensor:
    flat = data.reshape(-1).float()
    pad = (-flat.numel()) % vector_dim
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, vector_dim)


def kmeans_vq(data: torch.Tensor, num_bits: int, vector_dim: int = 2,
              max_iterations: int = 100, tolerance: float = 1e-6,
              seed: int = 42):
    """K-means VQ: the data zero-padded to a multiple of ``vector_dim`` and
    cut into vectors; ``2^b`` first centroids drawn without replacement
    (``torch.randperm`` of a generator seeded with ``seed``). Returns
    (quantized, centroids, indices, distortion)."""
    n = data.numel()
    vecs = _vectors(data, vector_dim)
    k = min(2 ** num_bits, vecs.shape[0])
    gen = torch.Generator().manual_seed(seed)
    init = torch.randperm(vecs.shape[0], generator=gen)[:k]
    centroids, dist = kmeans_fixed_point(vecs, vecs[init.to(vecs.device)],
                                         max_iterations, tolerance)
    idx = _assign_vectors(vecs)(centroids)
    quant = centroids[idx].reshape(-1)[:n]
    return quant.reshape(data.shape), centroids, idx, dist


# ---------------------------------------------------------------------------
# Dispatcher and model application
# ---------------------------------------------------------------------------

def compute_distortion(original: torch.Tensor, quantized: torch.Tensor,
                       metric: str = "mse") -> float:
    if metric == "mse":
        return float(((original - quantized) ** 2).mean())
    if metric == "mae":
        return float((original - quantized).abs().mean())
    raise ValueError(f"unknown metric {metric!r}")


def scl_quantize(data, params: Optional[SCLQuantizationParams] = None
                 ) -> SCLQuantizationResult:
    """Run the configured baseline on ``data`` (a tensor, on its device)
    and compute rate, distortion and compression ratio against fp16."""
    if params is None:
        params = SCLQuantizationParams()
    data = torch.as_tensor(data)
    if params.method == "scalar":
        quantized, codebook, indices = scalar_quantize_uniform(
            data, params.num_bits)
        distortion = compute_distortion(data.float(), quantized,
                                        params.distortion_metric)
    elif params.method == "lloyd_max":
        quantized, codebook, indices, dist = lloyd_max(
            data, params.num_bits, params.max_iterations, params.tolerance)
        distortion = float(dist)
    elif params.method == "vector":
        quantized, codebook, indices, dist = kmeans_vq(
            data, params.num_bits, params.vector_dim, params.max_iterations,
            params.tolerance, params.random_seed)
        distortion = float(dist)
    else:
        raise ValueError(f"unknown method {params.method!r}")

    n_entries = int(codebook.shape[0])
    rate = float(np.log2(n_entries))
    if params.method == "vector":
        rate /= params.vector_dim
    original_bits = data.numel() * 16
    compressed_bits = data.numel() * rate
    ratio = original_bits / compressed_bits if compressed_bits > 0 else 0.0
    return SCLQuantizationResult(
        quantized=quantized, codebook=codebook, indices=indices, rate=rate,
        distortion=distortion, compression_ratio=ratio,
        num_codebook_entries=n_entries, method=params.method)


def apply_scl_baseline_to_params(params_tree, layer_names=None,
                                 scl_params: Optional[
                                     SCLQuantizationParams] = None):
    """Quantize every 2-D tensor of a params tree (nested dataclasses and
    lists), or those named in ``layer_names``. Names are the reference's
    pytree paths: a dataclass field ``.name``, a list index ``i``, joined
    by ``/`` (``.layers/0/.q_proj/.w``). Returns (new params tree,
    {name: SCLQuantizationResult})."""
    results = {}

    def walk(obj, path):
        if isinstance(obj, torch.Tensor):
            name = "/".join(path)
            if obj.dim() == 2 and (layer_names is None
                                   or name in layer_names):
                res = scl_quantize(obj, scl_params)
                results[name] = res
                return res.quantized.to(obj.dtype)
            return obj
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(o, path + [str(i)])
                             for i, o in enumerate(obj))
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{
                f.name: walk(getattr(obj, f.name), path + [f".{f.name}"])
                for f in dataclasses.fields(obj) if f.init})
        return obj

    return walk(params_tree, []), results
