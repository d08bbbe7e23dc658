"""Whole-step decode through the megakernel: one launch for every layer.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.
persistent``. :func:`decode_step_persistent` wraps
:func:`ops.megastep.megastep` with the model plumbing: the embedding rows,
the RoPE tables of the current positions, the end-of-step commit of the
staged K/V, the final norm and the head. On the card a step is one megastep
launch and one int8 head launch (``ops.kernels.int8_matmul``); the rest is
a little PyTorch glue.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.fused import (
    FusedStackedParams, _commit)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    HeadMajorQuantKVCache)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import megastep as MS


def persistent_supported(params: FusedStackedParams,
                         config: ModelConfig) -> bool:
    """Whether the whole-step megakernel can serve this model: MHA,
    128-aligned head_dim and hidden size, 2- or 4-bit packing, int8 factors
    in the N-concatenated ('l'/'lr') layout for the fused groups, int8-factor
    w4a8 o/down projections of the same rank (a multiple of 128), no biases,
    and an intermediate size that is a multiple of 128 and at most 128 *
    128 (the reference's checks, in its order)."""
    lp = params.layers
    qkv, gu = lp.qkv, lp.gateup
    o, dn = lp.o_proj, lp.down_proj
    if config.num_heads != config.num_kv_heads:
        return False
    if config.head_dim % 128 or config.hidden_size % 128:
        return False
    if qkv.L_cat is None or gu.L_cat is None:
        return False
    if qkv.b is not None or gu.b is not None:
        return False
    ranks = set(qkv.ranks) | set(gu.ranks)
    if not (isinstance(o, CalderaLinear) and isinstance(dn, CalderaLinear)):
        return False
    if o.b is not None or dn.b is not None:
        return False
    if o.L_scale is None or dn.L_scale is None or o.R_scale is None \
            or dn.R_scale is None:
        return False
    ranks |= {o.L.shape[2], dn.L.shape[2]}
    if len(ranks) != 1 or next(iter(ranks)) % 128:
        return False
    bits = {qkv.num_bits, gu.num_bits, o.num_bits, dn.num_bits}
    if len(bits) != 1 or next(iter(bits)) not in (2, 4):
        return False
    if config.intermediate_size % 128 or config.intermediate_size > 128 * 128:
        return False
    return True


class GateUpInterleaved(NamedTuple):
    """Gate/up tensors re-ordered into interleaved ``bng``-row blocks
    (``[gate_j ++ up_j]``) for the megakernel's gate/up stage. Build it once
    at load: the packed array is GB-scale at 7B, and re-ordering it per step
    would double the step's weight traffic."""
    packed: torch.Tensor
    scales: torch.Tensor
    L_cat: torch.Tensor
    L_scale_cat: torch.Tensor


def megastep_bng(im: int) -> int:
    """The megakernel's gate/up block width for this model."""
    return MS._bn(256, im)


def prepare_gateup_interleaved(gu, im: int) -> GateUpInterleaved:
    """Interleave a fused gate ++ up projection's rows by megastep blocks:
    one ``index_select`` per tensor over the permutation ``[gate_j ++
    up_j]``."""
    bng = megastep_bng(im)
    dev = gu.packed.device
    j = (torch.arange(im // bng, device=dev)[:, None] * bng
         + torch.arange(bng, device=dev)[None, :])        # (ng, bng)
    perm = torch.stack([j, im + j], dim=1).reshape(-1)
    return GateUpInterleaved(*(t.index_select(1, perm) for t in (
        gu.packed, gu.scales, gu.L_cat, gu.L_scale_cat)))


def megastep_operands(params: FusedStackedParams, tokens: torch.Tensor,
                      pos: torch.Tensor, cache: HeadMajorQuantKVCache,
                      config: ModelConfig, prep: GateUpInterleaved = None):
    """The operands of one step's :func:`ops.megastep.megastep` call:
    ``(positional operands, keyword arguments)``. The embedding rows, the
    (B, D/2) RoPE tables of ``pos``, ``gs_all`` = ``[q, k, v, o, gate, up,
    down, 0]`` per layer, and the interleaved gate/up set (``prep``, or
    built in this call when None)."""
    lp = params.layers
    qkv, gu = lp.qkv, lp.gateup
    o, dn = lp.o_proj, lp.down_proj
    L = config.num_layers
    x0 = params.embed[tokens].float()
    cos, sin = llama.rope_tables(config, pos[:, None])   # (B, 1, half)
    gs_all = torch.cat([
        qkv.global_scale.reshape(L, 3), o.global_scale.reshape(L, 1),
        gu.global_scale.reshape(L, 2), dn.global_scale.reshape(L, 1),
        torch.zeros((L, 1), dtype=torch.float32, device=x0.device)],
        dim=1).float()
    if prep is None:
        prep = prepare_gateup_interleaved(gu, config.intermediate_size)
    args = (x0, pos, lp.attn_norm, lp.mlp_norm,
            qkv.packed, qkv.scales, qkv.R, qkv.R_scale, qkv.L_cat,
            qkv.L_scale_cat,
            o.packed, o.scales, o.R, o.R_scale, o.L, o.L_scale,
            prep.packed, prep.scales, gu.R, gu.R_scale, prep.L_cat,
            prep.L_scale_cat,
            dn.packed, dn.scales, dn.R, dn.R_scale, dn.L, dn.L_scale,
            gs_all, cache.k, cache.k_scale, cache.v, cache.v_scale,
            cos[:, 0, :], sin[:, 0, :])
    kw = dict(num_bits=qkv.num_bits, rank=o.L.shape[2],
              eps=config.rms_norm_eps,
              kvhd=(config.num_kv_heads, config.head_dim))
    return args, kw


def decode_step_persistent(params: FusedStackedParams, tokens: torch.Tensor,
                           pos: torch.Tensor, cache, config: ModelConfig,
                           staged_kv: str = "uniform",
                           prep: GateUpInterleaved = None):
    """Batched decode step through the whole-step megakernel.

    The contract of ``decode_step_fused(staged_kv=...)`` on a head-major int8
    cache: the cache holds tokens ``< pos``; this step's K/V are committed at
    column ``pos[b]`` of each row on return, in place. The reference's
    ``staged_kv="uniform"`` commits column ``pos[0]`` for every row and falls
    back to per-row writes for ragged positions; the port's indexed commit
    (``fused._commit``) gives both results for any ``staged_kv``. ``prep``:
    :func:`prepare_gateup_interleaved` of the params, built once; None
    interleaves in this call. Returns ``(logits (B, vocab) f32, cache)``.
    """
    if not isinstance(cache, HeadMajorQuantKVCache):
        raise ValueError("decode_step_persistent requires a "
                         "HeadMajorQuantKVCache")
    if not persistent_supported(params, config):
        raise ValueError("model not supported by the persistent kernel "
                         "(need MHA, 128-aligned head_dim/rank, int8 "
                         "'l'-layout factors; see persistent_supported)")
    resolve_device(tokens.device)
    args, kw = megastep_operands(params, tokens, pos, cache, config, prep)
    xo, k8, ks8, v8, vs8 = MS.megastep(*args, **kw)
    _commit(cache, (k8, ks8, v8, vs8), pos)
    logits = llama._logits(xo, params.embed, params.final_norm,
                           params.lm_head, config)
    return logits, cache
