"""Tensor-parallel decode and prefill of the stacked W4A8 model, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.parallel.
tp_decode``: Megatron sharding of ``models.stacked.decode_step_w4a8``, one
SPMD program per rank (where the reference runs ``shard_map``), the kernels
on each rank's shard and two ``all_reduce`` SUMs per layer (after o_proj and
down_proj):

- **column parallel** q/k/v/gate/up: output features (attention heads, MLP
  channels) sharded over the tp group, activations replicated;
- **row parallel** o/down: input features sharded; each rank's partial
  product is summed over the group. The packed codes are repacked exactly
  per K-shard (:func:`repack_row_parallel_stacked`: the same codes and row
  scales, in shard-local bit planes); each rank quantizes its activations
  with its own absmax, as the reference's stacked path does;
- **KV cache** sharded over the kv heads: attention needs no collective;
- **lm_head** sharded over the vocabulary; the ranks' logits are gathered,
  so every rank returns the full logits the reference's global value holds.

The sharding functions take the unsharded params (as ``interop`` loads them
or ``bench_params`` builds them) and return this rank's shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama, stacked
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.stacked import (
    StackedModelParams)
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import comm
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel.tp_kernels import (
    _block)

_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("o_proj", "down_proj")


def _repack_shard(pk: torch.Tensor, num_bits: int, shards: int,
                  s: int) -> torch.Tensor:
    """Shard ``s``'s bytes (..., K/(f shards)) of the exact K-shard repack of
    plane-packed codes ``pk`` (..., K/f)."""
    f = 8 // num_bits
    ks = pk.shape[-1] * f // shards
    mask = (1 << num_bits) - 1
    u = torch.cat([torch.bitwise_right_shift(pk, num_bits * (f - 1 - p))
                   & mask for p in range(f)], dim=-1)     # code order
    g = u[..., s * ks:(s + 1) * ks].reshape(*u.shape[:-1], f, ks // f)
    out = torch.zeros(g.shape[:-2] + (ks // f,), dtype=torch.uint8,
                      device=pk.device)
    for p in range(f):
        out |= torch.bitwise_left_shift(g[..., p, :], num_bits * (f - 1 - p))
    return out


def _check_repack(packed: torch.Tensor, num_bits: int, shards: int) -> int:
    f = 8 // num_bits
    K = packed.shape[-1] * f
    if K % shards:
        raise ValueError(f"K={K} not divisible by {shards} shards")
    if (K // shards) % f:
        raise ValueError(f"shard width {K // shards} not divisible by pack "
                         f"factor {f}")
    return f


def repack_row_parallel_stacked(packed: torch.Tensor, num_bits: int,
                                shards: int) -> torch.Tensor:
    """Exactly repack stacked w4a8 codes ``(L, N, K*bits/8)`` (or a flat
    ``(N, K*bits/8)``) for K-sharding.

    The serving layout is plane-major over the whole row (byte ``c`` holds
    the codes of ``k = p * plane_len + c``), so a plain slice of the byte
    axis scrambles the k order. This unpacks to code order, cuts K into
    ``shards`` ranges and repacks each range plane-major on its own; byte
    range ``s`` of the result is shard ``s``'s standalone packing. Codes and
    row scales are unchanged: the repack is bit-exact. One layer at a time,
    so the unpacked codes never exist for the whole stack."""
    f = _check_repack(packed, num_bits, shards)
    if f == 1 or shards == 1:
        return packed
    if packed.dim() == 2:
        return torch.cat([_repack_shard(packed, num_bits, shards, s)
                          for s in range(shards)], dim=-1)
    return torch.stack([repack_row_parallel_stacked(p, num_bits, shards)
                        for p in packed])


def _repack_local(packed: torch.Tensor, num_bits: int, shards: int,
                  s: int) -> torch.Tensor:
    """Shard ``s`` of :func:`repack_row_parallel_stacked`, alone."""
    f = _check_repack(packed, num_bits, shards)
    if f == 1 or shards == 1:
        return _block(packed, packed.dim() - 1, s, shards)
    return torch.stack([_repack_shard(p, num_bits, shards, s)
                        for p in packed])


# Specs: per tensor dimension the mesh dim it is sharded over, or None; ()
# replicates (the reference's PartitionSpec).

def _param_spec(names, axis: str) -> tuple:
    """The spec of one StackedModelParams leaf, by its path."""
    if "lm_head" in names:
        field = names[-1]
        if field in ("w", "w8", "scales"):
            return (axis, None)                      # vocab-sharded head
        if field == "b":
            return (axis,)
        return ()
    proj = next((n for n in names if n in _COL or n in _ROW), None)
    if proj is None:
        return ()                                    # embed / norms
    field = names[-1]
    if proj in _COL:
        if field in ("packed", "scales", "L", "L_scale"):
            return (None, axis, None)                # output features
        if field == "b":
            return (None, axis)
        return ()                                    # R / R_scale / gs
    if field in ("packed", "scales", "R"):
        return (None, None, axis)                    # input features
    return ()                                        # L / L_scale / gs / b


def _cache_spec(cache, axis: str) -> tuple:
    """KV caches shard the kv-head axis (dim 3 of (L, B, T, KVH, D))."""
    return tuple((None, None, None, axis, None) if x.dim() == 5
                 else (None, None, None, axis)
                 for x in _tensors(cache))


def _tensors(obj):
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def _map_with_path(fn, obj, path=()):
    """``fn(path, tensor)`` over the tensors of nested dataclasses and
    tuples (``path``: the field names and indices down to the tensor)."""
    if isinstance(obj, torch.Tensor):
        return fn(path, obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_with_path(fn, getattr(obj, f.name),
                                   path + (f.name,))
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (torch.Tensor, tuple))
            or dataclasses.is_dataclass(getattr(obj, f.name))})
    if isinstance(obj, tuple):
        return tuple(_map_with_path(fn, v, path + (str(i),))
                     for i, v in enumerate(obj))
    return obj


def _local(x: torch.Tensor, spec: tuple, axis: str, rank: int,
           size: int) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (``x`` itself when
    replicated)."""
    for dim, a in enumerate(spec):
        if a == axis:
            return _block(x, dim, rank, size)
    return x


def shard_stacked_model_tp(params: StackedModelParams, mesh,
                           axis: str = "tp") -> StackedModelParams:
    """This rank's shard of a stacked w4a8 model for tensor-parallel
    serving.

    Row-parallel projections (o/down) get their codes exactly repacked per
    K-shard (this rank's bytes) and keep their per-row scales (the local
    view of the reference's ``(..., tp)`` broadcast); everything else is cut
    by :func:`_param_spec`. A tied (None) lm_head is materialized from the
    embedding, so it can be vocab-sharded apart from the replicated
    embedding."""
    tp, rank = comm.axis_size(mesh, axis), comm.axis_rank(mesh, axis)
    fields = {}
    for f in dataclasses.fields(llama.LayerParams):
        lin = getattr(params.layers, f.name)
        if f.name in _ROW:
            if not isinstance(lin, CalderaLinear) or lin.mode != "w4a8":
                raise ValueError(f"{f.name} must be a stacked w4a8 "
                                 "CalderaLinear for TP serving")
            if lin.b is not None:
                raise ValueError(f"row-parallel {f.name} cannot carry a "
                                 "bias")
            lin = dataclasses.replace(
                lin, packed=_repack_local(lin.packed, lin.num_bits, tp, rank),
                R=_block(lin.R, 2, rank, tp))
        else:
            lin = _map_with_path(
                lambda path, x, n=f.name: _local(
                    x, _param_spec(("layers", n) + path, axis), axis, rank,
                    tp), lin)
        fields[f.name] = lin
    lm_head = params.lm_head
    if lm_head is None:
        lm_head = DenseLinear(w=params.embed)
    lm_head = _map_with_path(
        lambda path, x: _local(x, _param_spec(("lm_head",) + path, axis),
                               axis, rank, tp), lm_head)
    return StackedModelParams(embed=params.embed,
                              layers=llama.LayerParams(**fields),
                              final_norm=params.final_norm, lm_head=lm_head)


def shard_kv_cache_tp(cache, mesh, axis: str = "tp"):
    """This rank's kv heads of a (Quant)KVCache."""
    tp, rank = comm.axis_size(mesh, axis), comm.axis_rank(mesh, axis)
    return dataclasses.replace(cache, **{
        f.name: _local(getattr(cache, f.name), spec, axis, rank, tp)
        for f, spec in zip(dataclasses.fields(cache),
                           _cache_spec(cache, axis))})


def _local_config(config: ModelConfig, tp: int) -> ModelConfig:
    for field in ("num_heads", "num_kv_heads", "intermediate_size",
                  "vocab_size"):
        if getattr(config, field) % tp:
            raise ValueError(f"{field}={getattr(config, field)} not "
                             f"divisible by tp={tp}")
    return dataclasses.replace(
        config,
        num_heads=config.num_heads // tp,
        num_kv_heads=config.num_kv_heads // tp,
        intermediate_size=config.intermediate_size // tp,
        vocab_size=config.vocab_size // tp)


def decode_step_w4a8_tp(params: StackedModelParams, tokens: torch.Tensor,
                        pos: torch.Tensor, cache, config: ModelConfig, mesh,
                        axis: str = "tp"):
    """Tensor-parallel batched decode step (see the module docstring).

    ``params`` from :func:`shard_stacked_model_tp`, ``cache`` from
    :func:`shard_kv_cache_tp`; ``tokens``, ``pos`` (B,) the same on every
    rank. Returns (logits (B, vocab), cache), the logits gathered over the
    group and the cache (this rank's heads) written in place."""
    group = comm.axis_group(mesh, axis)
    cfg_local = _local_config(config, comm.axis_size(mesh, axis))
    logits, cache = stacked.decode_step_w4a8(params, tokens, pos, cache,
                                             cfg_local, tp_axis=group)
    return comm.gather_last(logits, group), cache


def prefill_into_slot_w4a8_tp(params: StackedModelParams,
                              tokens: torch.Tensor, slot: int, cache,
                              config: ModelConfig, mesh, axis: str = "tp",
                              last_pos: Optional[int] = None):
    """Tensor-parallel prefill of one (1, S) prompt into ``slot``. Returns
    (logits (vocab,) of row ``last_pos``, gathered, cache)."""
    group = comm.axis_group(mesh, axis)
    cfg_local = _local_config(config, comm.axis_size(mesh, axis))
    logits, cache = stacked.prefill_into_slot_w4a8(
        params, tokens, slot, cache, cfg_local, last_pos=last_pos,
        tp_axis=group)
    return comm.gather_last(logits, group), cache
