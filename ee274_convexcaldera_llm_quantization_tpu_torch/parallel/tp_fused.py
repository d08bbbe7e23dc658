"""Tensor parallelism for the fused W4A8 serving step, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.parallel.
tp_fused``: ``models.fused.decode_step_fused`` itself (fused projections,
head-major int8 KV, flash decode attention, staged KV commits, int8
factors) sharded Megatron-style, one SPMD program per rank, with the two
``all_reduce`` SUMs per layer that ``decode_step_fused(tp_axis=...)``
makes:

- **column parallel** fused qkv / gate-up: output features sharded. A fused
  group concatenates its projections along N, so the rows are permuted at
  shard time (:func:`_group_permutation`) for rank ``s``'s contiguous block
  to hold ``[q_s; k_s; v_s]``, and the group's ``splits`` become the local
  ones (a row permutation of packed codes is exact: each row's bytes are
  its own).
- **row parallel** o/down: input features sharded with the exact bit-plane
  repack (``tp_decode.repack_row_parallel_stacked``), row scales kept,
  ``R`` K-sharded, ``L`` replicated. The activations quantize with the
  group's global row absmax and the K-partial ``xr`` is summed before its
  bf16 cast, so every int8 code equals the single-device step's and the
  output differs only by the f32 order of the sum over the ranks.
- **KV cache** (head-major) and **paged pool**: kv heads sharded;
  attention needs no collective.
- **lm_head** vocab-sharded (a tied head becomes an int8 head); the ranks'
  logits are gathered, so every rank returns the full logits.

The sharding functions take the unsharded params and return this rank's
shard; the steps take the shards, the full config and the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear, Int8Linear, quantize_linear_int8)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.fused import (
    FusedLayerStack, FusedStackedParams, FusedW4A8Linear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    HeadMajorQuantKVCache)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import comm
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel.tp_decode import (
    _local, _local_config, _repack_local)
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel.tp_kernels import (
    _block)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import paged


def _group_permutation(splits, tp: int) -> np.ndarray:
    """Row order that makes a plain contiguous N-shard of a fused group
    yield ``[proj0_s; proj1_s; ...]`` on shard ``s``."""
    offs = np.cumsum([0] + list(splits))
    order = []
    for s in range(tp):
        for i, n in enumerate(splits):
            ns = n // tp
            order.extend(range(offs[i] + s * ns, offs[i] + (s + 1) * ns))
    return np.asarray(order, np.int64)


def _head_specs(lm_head, axis: str):
    if isinstance(lm_head, Int8Linear):
        return dataclasses.replace(
            lm_head, w8=(axis, None), scales=(axis, None),
            b=None if lm_head.b is None else (axis,))
    if isinstance(lm_head, DenseLinear):
        return dataclasses.replace(
            lm_head, w=(axis, None), b=None if lm_head.b is None else (axis,))
    raise ValueError(f"unsupported lm_head {type(lm_head).__name__} for TP "
                     "(shard_fused_model_tp materializes a tied head)")


def _check_col_group(fp: FusedW4A8Linear, tp: int) -> tuple:
    """The group's local splits, checked."""
    for n in fp.splits:
        if n % tp:
            raise ValueError(f"fused group splits {fp.splits} not divisible "
                             f"by tp={tp}")
    local_splits = tuple(n // tp for n in fp.splits)
    if fp.L_cat is not None and not K.lr_stacked_supported(
            local_splits, fp.ranks, num_bits=fp.num_bits):
        raise ValueError(
            f"local splits {local_splits} unsupported by the fused-factor "
            "kernel; use factor_kernel='xla' params for this tp degree")
    return local_splits


def _permute_rows(fp: FusedW4A8Linear, rows: np.ndarray, **kw):
    """``fp`` with the N-concatenated tensors taking the rows ``rows``."""
    idx = torch.from_numpy(rows).to(fp.packed.device)

    def take(a):
        return None if a is None else a.index_select(1, idx)
    return dataclasses.replace(
        fp, packed=take(fp.packed), scales=take(fp.scales), b=take(fp.b),
        L_cat=take(fp.L_cat), L_scale_cat=take(fp.L_scale_cat), **kw)


def _shard_col_group(fp: FusedW4A8Linear, tp: int) -> FusedW4A8Linear:
    """Permute a column-parallel fused group for contiguous N-sharding and
    switch its ``splits`` to the per-shard values: the reference's whole
    permuted group, whose contiguous block ``s`` is rank ``s``'s."""
    local_splits = _check_col_group(fp, tp)
    return _permute_rows(fp, _group_permutation(fp.splits, tp),
                         splits=local_splits)


def _local_col_group(fp: FusedW4A8Linear, tp: int,
                     rank: int) -> FusedW4A8Linear:
    """This rank's block of :func:`_shard_col_group`, gathered straight from
    the unpermuted group: its rows of the N-concatenated tensors, its
    contiguous block of each projection's own ``Ls`` / ``L_scales``."""
    local_splits = _check_col_group(fp, tp)
    n = sum(local_splits)
    rows = _group_permutation(fp.splits, tp)[rank * n:(rank + 1) * n]
    return _permute_rows(
        fp, rows, splits=local_splits,
        Ls=tuple(_block(x, 1, rank, tp) for x in fp.Ls),
        L_scales=(None if fp.L_scales is None else tuple(
            _block(x, 1, rank, tp) for x in fp.L_scales)))


def _check_row_linear(lin) -> None:
    if not isinstance(lin, CalderaLinear) or lin.mode != "w4a8":
        raise ValueError("row-parallel projections must be stacked w4a8 "
                         f"CalderaLinear, got {type(lin).__name__}")
    if lin.b is not None:
        raise ValueError("row-parallel projection cannot carry a bias")


def _local_row_linear(lin: CalderaLinear, tp: int,
                      rank: int) -> CalderaLinear:
    """This rank's shard of a row-parallel stacked w4a8 CalderaLinear: its
    bytes of the exact K-shard repack (``repack_row_parallel_stacked``), its
    columns of ``R``; the row scales (L, N, 1) are the local view of the
    reference's ``(L, N, tp)`` broadcast."""
    _check_row_linear(lin)
    return dataclasses.replace(
        lin, packed=_repack_local(lin.packed, lin.num_bits, tp, rank),
        R=_block(lin.R, 2, rank, tp))


def _local_head(lm_head, axis: str, rank: int, tp: int):
    spec = _head_specs(lm_head, axis)
    return dataclasses.replace(lm_head, **{
        f.name: _local(getattr(lm_head, f.name), getattr(spec, f.name),
                       axis, rank, tp)
        for f in dataclasses.fields(lm_head)
        if getattr(lm_head, f.name) is not None})


def _tied_head(params):
    """The head, a tied (None) one materialized as an int8 head."""
    if params.lm_head is None:
        return quantize_linear_int8(DenseLinear(w=params.embed))
    return params.lm_head


def _local_fused(params: FusedStackedParams, tp: int, rank: int,
                 axis: str = "tp") -> FusedStackedParams:
    """This rank's shard of unsharded fused params."""
    lp = params.layers
    return FusedStackedParams(
        embed=params.embed,
        layers=FusedLayerStack(
            attn_norm=lp.attn_norm, qkv=_local_col_group(lp.qkv, tp, rank),
            o_proj=_local_row_linear(lp.o_proj, tp, rank),
            mlp_norm=lp.mlp_norm,
            gateup=_local_col_group(lp.gateup, tp, rank),
            down_proj=_local_row_linear(lp.down_proj, tp, rank)),
        final_norm=params.final_norm,
        lm_head=_local_head(_tied_head(params), axis, rank, tp))


def shard_fused_model_tp(params: FusedStackedParams, mesh,
                         axis: str = "tp") -> FusedStackedParams:
    """This rank's shard of a fused w4a8 model for tensor-parallel serving.

    The shard carries the local ``splits`` on its fused groups, so it is
    valid only for the ``*_tp`` steps over ``mesh``. A tied (None) lm_head
    is materialized as an int8 head so it can be vocab-sharded apart from
    the replicated embedding."""
    return _local_fused(params, comm.axis_size(mesh, axis),
                        comm.axis_rank(mesh, axis), axis)


def _cache_spec(cache: HeadMajorQuantKVCache, axis: str):
    """Head-major caches shard the kv-head axis (dim 2)."""
    del cache
    return HeadMajorQuantKVCache(
        k=(None, None, axis, None, None), v=(None, None, axis, None, None),
        k_scale=(None, None, axis, None), v_scale=(None, None, axis, None))


def _cut_cache(cache, specs, mesh, axis: str):
    tp, rank = comm.axis_size(mesh, axis), comm.axis_rank(mesh, axis)
    return dataclasses.replace(cache, **{
        f.name: _local(getattr(cache, f.name), getattr(specs, f.name), axis,
                       rank, tp)
        for f in dataclasses.fields(cache)})


def shard_headmajor_cache_tp(cache: HeadMajorQuantKVCache, mesh,
                             axis: str = "tp") -> HeadMajorQuantKVCache:
    """This rank's kv heads of a head-major quantized KV cache."""
    return _cut_cache(cache, _cache_spec(cache, axis), mesh, axis)


def _local_step(mesh, axis: str, config: ModelConfig):
    return (comm.axis_group(mesh, axis),
            _local_config(config, comm.axis_size(mesh, axis)))


def decode_step_fused_tp(params: FusedStackedParams, tokens: torch.Tensor,
                         pos: torch.Tensor, cache: HeadMajorQuantKVCache,
                         config: ModelConfig, mesh, axis: str = "tp",
                         staged_kv="uniform", attn_dots: str = "f32",
                         attn_kernel: str = "row",
                         proj_kernel: str = "grid"):
    """Tensor-parallel batched decode step on the fused path.

    ``params`` from :func:`shard_fused_model_tp`, ``cache`` from
    :func:`shard_headmajor_cache_tp`, ``tokens``/``pos`` (B,) the same on
    every rank. Returns (logits (B, vocab) gathered over the group, cache),
    the cache written in place. ``staged_kv`` etc. as in
    ``fused.decode_step_fused`` (the port's per-row commit serves ragged
    rows under "uniform" too)."""
    group, cfg_local = _local_step(mesh, axis, config)
    logits, cache = fused.decode_step_fused(
        params, tokens, pos, cache, cfg_local, staged_kv=staged_kv,
        attn_dots=attn_dots, attn_kernel=attn_kernel,
        proj_kernel=proj_kernel, tp_axis=group)
    return comm.gather_last(logits, group), cache


def prefill_into_slot_fused_tp(params: FusedStackedParams,
                               tokens: torch.Tensor, slot: int,
                               cache: HeadMajorQuantKVCache,
                               config: ModelConfig, mesh, axis: str = "tp",
                               last_pos: Optional[int] = None,
                               flash: bool = False):
    """Tensor-parallel prefill of one (1, S) prompt on the fused path.
    Returns (logits (vocab,) of row ``last_pos``, gathered, cache)."""
    group, cfg_local = _local_step(mesh, axis, config)
    logits, cache = fused.prefill_into_slot_fused(
        params, tokens, slot, cache, cfg_local, last_pos=last_pos,
        flash=flash, tp_axis=group)
    return comm.gather_last(logits, group), cache


def _pool_spec(axis: str):
    """Paged pools shard the kv-head axis (dim 2 of (L, NP, KVH, P, D))."""
    return paged.PagedQuantKVPool(
        k=(None, None, axis, None, None), v=(None, None, axis, None, None),
        k_scale=(None, None, axis, None), v_scale=(None, None, axis, None))


def shard_paged_pool_tp(pool, mesh, axis: str = "tp"):
    """This rank's kv heads of a paged int8 KV pool. Page numbering is the
    same on every rank (each holds the same pages for its heads), so the
    host's allocator and page tables are unchanged."""
    return _cut_cache(pool, _pool_spec(axis), mesh, axis)


def paged_decode_step_fused_tp(params: FusedStackedParams,
                               tokens: torch.Tensor, pos: torch.Tensor,
                               pool, page_tables: torch.Tensor,
                               config: ModelConfig, mesh, axis: str = "tp",
                               active: Optional[torch.Tensor] = None,
                               scratch_page: Optional[int] = None,
                               attn_dots: str = "f32"):
    """Tensor-parallel paged decode on the fused path: paging and Megatron
    TP on one step. ``params`` from :func:`shard_fused_model_tp`, ``pool``
    from :func:`shard_paged_pool_tp`; the page tables are the same on every
    rank. Returns (logits (B, vocab) gathered, pool)."""
    group, cfg_local = _local_step(mesh, axis, config)
    logits, pool = paged.paged_decode_step_fused(
        params, tokens, pos, pool, page_tables, cfg_local, active=active,
        scratch_page=scratch_page, tp_axis=group, attn_dots=attn_dots)
    return comm.gather_last(logits, group), pool


def paged_prefill_fused_tp(params: FusedStackedParams, tokens: torch.Tensor,
                           pool, page_table: torch.Tensor,
                           config: ModelConfig, mesh, axis: str = "tp",
                           flash: bool = False):
    """Tensor-parallel paged prefill on the fused path (the admission side
    of :func:`paged_decode_step_fused_tp`). Returns (last-token logits
    (vocab,) gathered, pool)."""
    group, cfg_local = _local_step(mesh, axis, config)
    logits, pool = paged.paged_prefill_fused(
        params, tokens, pool, page_table, cfg_local, flash=flash,
        tp_axis=group)
    return comm.gather_last(logits, group), pool
