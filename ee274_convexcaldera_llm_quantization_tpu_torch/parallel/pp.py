"""Pipeline-parallel decode (layer stages over ranks), in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.parallel.pp``:
the layer axis of a stacked model is cut into ``S`` stages over the ``pp``
dim of a device mesh, so stage ``s`` holds layers ``[s*L/S, (s+1)*L/S)``
(codes, scales, factors, norms) and their KV cache for the full batch; the
embedding, final norm and head are replicated.

One decode step splits the batch into ``S`` microbatches. Where the
reference runs a ``2S - 1``-tick GPipe ring with a ``ppermute`` per tick,
each stage here runs a plain send/recv pipeline: for each microbatch in
order, stage 0 embeds it, every stage runs its layers on it
(``stacked.decode_layers_w4a8`` or ``fused.decode_layers_fused``, the
kernels of the single-device step) and sends the activations to the next
stage, and the last stage computes its logits. So every stage computes the
same layers on the same microbatches as the reference's; stage 0 starts
the next microbatch while the later stages work on the last one. The last
stage's logits are then broadcast over the stage group (the reference sums
them, the other stages holding zeros). Under ``tp_axis`` (PP x TP) each
stage's layer slice runs Megatron TP within the stage's tp group and the
vocab-sharded logits are gathered.

Use TP (``parallel.tp_fused``) for latency; PP buys device memory for its
``B/S x hidden`` floats of traffic per hop.
"""

from __future__ import annotations

import dataclasses

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    fused, llama, stacked)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    DenseLinear, quantize_linear_int8)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.stacked import (
    StackedModelParams)
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import comm
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import (
    tp_decode, tp_fused)
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel.tp_kernels import (
    _block)


def _stage_layers(layers, mesh, axis: str):
    """This stage's slice of layer-stacked params."""
    S, s = comm.axis_size(mesh, axis), comm.axis_rank(mesh, axis)
    return tp_decode._map_with_path(lambda path, x: _block(x, 0, s, S),
                                    layers)


def shard_stacked_model_pp(params: StackedModelParams, mesh,
                           axis: str = "pp") -> StackedModelParams:
    """This stage's slice of a stacked w4a8 model. A tied (None) lm_head is
    materialized from the embedding so the last stage computes logits from
    its own copy."""
    lm_head = params.lm_head
    if lm_head is None:
        lm_head = DenseLinear(w=params.embed)
    return StackedModelParams(embed=params.embed,
                              layers=_stage_layers(params.layers, mesh, axis),
                              final_norm=params.final_norm, lm_head=lm_head)


def shard_fused_model_pp(params, mesh, axis: str = "pp"):
    """This stage's slice of a fused w4a8 model (every ``layers`` tensor has
    the leading layer axis). A tied (None) head becomes an int8 head, as on
    the single-device fused path."""
    lm_head = params.lm_head
    if lm_head is None:
        lm_head = quantize_linear_int8(DenseLinear(w=params.embed))
    return dataclasses.replace(
        params, layers=_stage_layers(params.layers, mesh, axis),
        lm_head=lm_head)


def shard_kv_cache_pp(cache, mesh, axis: str = "pp"):
    """This stage's layers of a KV cache (any of the port's caches)."""
    S, s = comm.axis_size(mesh, axis), comm.axis_rank(mesh, axis)
    return dataclasses.replace(cache, **{
        f.name: _block(getattr(cache, f.name), 0, s, S)
        for f in dataclasses.fields(cache)})


def shard_fused_model_pp_tp(params, mesh, pp_axis: str = "pp",
                            tp_axis: str = "tp"):
    """This rank's shard of a fused w4a8 model for PP x TP serving: the TP
    shard of ``parallel.tp_fused`` (fused-group permutation and local
    splits, exact row-parallel repack, a vocab-sharded head; a tied head
    made int8) for its tp coordinate, then its stage's layers."""
    tp_local = tp_fused._local_fused(
        params, comm.axis_size(mesh, tp_axis),
        comm.axis_rank(mesh, tp_axis), tp_axis)
    return dataclasses.replace(
        tp_local, layers=_stage_layers(tp_local.layers, mesh, pp_axis))


def shard_headmajor_cache_pp_tp(cache, mesh, pp_axis: str = "pp",
                                tp_axis: str = "tp"):
    """This rank's (layers, kv heads) block of a head-major int8 cache."""
    return shard_kv_cache_pp(
        tp_fused.shard_headmajor_cache_tp(cache, mesh, tp_axis), mesh,
        pp_axis)


def _stages(config: ModelConfig, B: int, S: int):
    if config.num_layers % S:
        raise ValueError(f"num_layers={config.num_layers} not divisible by "
                         f"pp={S}")
    if B % S:
        raise ValueError(f"batch={B} not divisible by pp={S} microbatches")
    return B // S, dataclasses.replace(config,
                                       num_layers=config.num_layers // S)


def _pipeline(params, tokens, pos, cache, config: ModelConfig, mesh,
              axis: str, layers_fn, vocab: int):
    """The send/recv pipeline of one decode step (see the module
    docstring); ``layers_fn(x, pos, cache, row0)`` runs this stage's layers
    on one microbatch. Returns the logits (B, vocab) on every stage."""
    group = comm.axis_group(mesh, axis)
    S, s = comm.axis_size(mesh, axis), comm.axis_rank(mesh, axis)
    B = tokens.shape[0]
    Bmu, _ = _stages(config, B, S)
    dev = tokens.device
    hidden = params.embed.shape[1]
    logits = torch.zeros((B, vocab), dtype=torch.float32, device=dev)
    for m in range(S):
        rows = slice(m * Bmu, (m + 1) * Bmu)
        if s == 0:
            x = params.embed[tokens[rows]].float()
        else:
            x = comm.recv((Bmu, hidden), torch.float32, dev, group, s - 1)
        x, cache = layers_fn(x, pos[rows], cache, m * Bmu)
        if s < S - 1:
            comm.send(x, group, s + 1)
        else:
            logits[rows] = llama._logits(x, params.embed, params.final_norm,
                                         params.lm_head, config)
    return comm.broadcast(logits, group, S - 1), cache


def decode_step_w4a8_pp(params: StackedModelParams, tokens: torch.Tensor,
                        pos: torch.Tensor, cache, config: ModelConfig, mesh,
                        axis: str = "pp"):
    """Pipeline-parallel batched decode step on the stacked W4A8 path.

    ``params`` from :func:`shard_stacked_model_pp`, ``cache`` from
    :func:`shard_kv_cache_pp` (a bf16 ``KVCache`` or an int8
    ``QuantKVCache``); ``tokens``/``pos`` (B,) the same on every stage, with
    ``B % stages == 0`` and ``config.num_layers % stages == 0``. Returns
    (logits (B, vocab) on every stage, cache written in place)."""
    _, cfg_stage = _stages(config, tokens.shape[0],
                           comm.axis_size(mesh, axis))

    def layers_fn(x, p, cache, row0):
        return stacked.decode_layers_w4a8(params.layers, x, p, cache,
                                          cfg_stage, row0=row0)
    return _pipeline(params, tokens, pos, cache, config, mesh, axis,
                     layers_fn, config.vocab_size)


def decode_step_fused_pp(params, tokens: torch.Tensor, pos: torch.Tensor,
                         cache, config: ModelConfig, mesh, axis: str = "pp",
                         tp_axis=None, attn_dots: str = "f32",
                         proj_kernel: str = "grid"):
    """Pipeline-parallel decode on the fused path: each stage runs its layer
    slice through ``fused.decode_layers_fused`` (fused projections, staged
    flash attention, int8 factors, per-row staged commits), so PP serves
    the single-device step's layer body.

    ``params`` from :func:`shard_fused_model_pp` (or, with ``tp_axis`` the
    mesh's tp dim name, :func:`shard_fused_model_pp_tp`), ``cache`` a
    head-major int8 cache from :func:`shard_kv_cache_pp` (or
    :func:`shard_headmajor_cache_pp_tp`). ``attn_dots`` as in
    ``fused.decode_step_fused`` (the reference's layer body is f32). Returns
    (logits (B, vocab) on every rank, gathered over tp, cache)."""
    _, cfg_stage = _stages(config, tokens.shape[0],
                           comm.axis_size(mesh, axis))
    group, vocab = None, config.vocab_size
    if tp_axis is not None:
        tp = comm.axis_size(mesh, tp_axis)
        cfg_stage = tp_decode._local_config(cfg_stage, tp)
        group, vocab = comm.axis_group(mesh, tp_axis), config.vocab_size // tp

    def layers_fn(x, p, cache, row0):
        return fused.decode_layers_fused(
            params.layers, x, p, cache, cfg_stage, tp_axis=group,
            proj_kernel=proj_kernel, attn_dots=attn_dots, row0=row0)
    logits, cache = _pipeline(params, tokens, pos, cache, config, mesh, axis,
                              layers_fn, vocab)
    if group is not None:
        logits = comm.gather_last(logits, group)
    return logits, cache
