"""Tensor-parallel wrappers of the flat W4A8 kernel, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.parallel.
tp_kernels``. Where the reference wraps the Pallas kernel in ``shard_map``,
each rank here runs the flat W4A8 kernel (``ops.kernels.
quantized_matmul_w4a8``, ``csrc/w4a8_stacked.cu`` on the card) on its own
shard and the Megatron collectives go around it:

- **column parallel** (q/k/v/gate/up): weights sharded on the output
  features, activations replicated; each rank computes its slice of the
  output and no collective runs (the consumer stays sharded);
- **row parallel** (o/down): weights and activations sharded on the input
  features; each rank computes a partial product over its K-range and an
  ``all_reduce`` SUM over the tp group completes it.

The low-rank factors follow the same layout: column-parallel shards ``L``
by rows; row-parallel shards ``R`` by columns with the rank replicated.
"""

from __future__ import annotations

import dataclasses

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import comm


def _block(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Block ``rank`` of ``size`` equal blocks of ``x`` along ``dim``, as a
    tensor of its own (the rest can be freed)."""
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"dimension {dim} of size {n} not divisible by "
                         f"{size} shards")
    return x.narrow(dim, rank * (n // size), n // size).clone(
        memory_format=torch.contiguous_format)


def column_parallel_w4a8(mesh, num_bits: int, axis: str = "tp"):
    """Returns ``f(x, packed, row_scales) -> y``: ``x`` (B, K) replicated,
    ``packed`` (N/tp, K/f) and ``row_scales`` (N/tp, 1) this rank's rows;
    ``y`` (B, N/tp) this rank's output columns."""
    del mesh, axis

    def local(x, packed, scales):
        return K.quantized_matmul_w4a8(x, packed, scales, num_bits)
    return local


def pack_rowscale_sharded(W: torch.Tensor, num_bits: int, shards: int):
    """Row-parallel packing: quantize and pack each K-shard on its own.

    The plane layout spans a whole row, so a plain slice of the packed axis
    scrambles the k order; each shard is packed locally and gets its own
    per-row scale. Returns ``(packed (N, K/f), shard_scales (N, shards))``
    where byte range ``s`` holds shard ``s``'s packing."""
    N, Kdim = W.shape
    if Kdim % shards:
        raise ValueError(f"K={Kdim} not divisible by {shards} shards")
    ks = Kdim // shards
    packs, scales = [], []
    for s in range(shards):
        p, sc = K.pack_rowscale(W[:, s * ks:(s + 1) * ks], num_bits)
        packs.append(p)
        scales.append(sc)
    return torch.cat(packs, dim=1), torch.cat(scales, dim=1)


def row_parallel_w4a8(mesh, num_bits: int, axis: str = "tp"):
    """Returns ``f(x, packed, shard_scales) -> y``: ``x`` (B, K/tp),
    ``packed`` (N, K/(f tp)) and ``shard_scales`` (N, 1) this rank's K-shard
    of :func:`pack_rowscale_sharded`'s output; ``y`` (B, N), the sum of the
    ranks' partial products. Each rank quantizes its activations with its
    own absmax, as the reference's."""
    group = comm.axis_group(mesh, axis)

    def local(x, packed, scales):
        partial = K.quantized_matmul_w4a8(x, packed, scales, num_bits)
        return comm.all_sum(partial, group)
    return local


def _shard_linear(lin, mesh, axis: str, dims: dict):
    """``lin`` with each tensor field in ``dims`` cut to this rank's block
    along its dim (the others kept whole)."""
    rank, size = comm.axis_rank(mesh, axis), comm.axis_size(mesh, axis)
    return dataclasses.replace(lin, **{
        name: _block(getattr(lin, name), dim, rank, size)
        for name, dim in dims.items() if getattr(lin, name) is not None})


def shard_caldera_linear_column(lin, mesh, axis: str = "tp"):
    """This rank's shard of a w4a8 CalderaLinear with the output features
    sharded: rows of packed, scales, L (and its scales) and the bias."""
    return _shard_linear(lin, mesh, axis, dict(
        packed=0, scales=0, L=0, L_scale=0, b=0))


def shard_caldera_linear_row(lin, mesh, axis: str = "tp"):
    """This rank's shard of a w4a8 CalderaLinear with the input features
    sharded: bytes of packed (weights packed by
    :func:`pack_rowscale_sharded`) and columns of R."""
    return _shard_linear(lin, mesh, axis, dict(packed=1, R=1))
