"""Tensor-parallel continuous-batching engine, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.serve.
tp_engine``: the host scheduler of :class:`serve.fast_engine.
FastServingEngine`, run on every rank of a tp group, with prefill and decode
through the whole-model TP steps. ``fused=True`` (the default) serves the
fused step under TP (``parallel.tp_fused``: fused qkv / gate-up, flash
decode attention on the rank's heads, the head-major int8 cache, staged
per-row commits, int8 factors); ``fused=False`` the stacked step
(``parallel.tp_decode``) on a bf16 or int8 token-major cache.

Every rank of the group must emit the same token, or the ranks' schedulers
diverge: each step's logits are gathered on every rank, the group's rank 0
samples, and the sampled tokens are broadcast to the others.
"""

from __future__ import annotations

from typing import Optional

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    fused, llama, stacked)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import (
    comm, tp_decode as tpd, tp_fused as tpf)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve.fast_engine import (
    FastServingEngine)


class TPServingEngine(FastServingEngine):
    """Continuous batching with every model step sharded over ``mesh``'s
    ``axis`` group (each rank of it runs this engine on the same requests).

    ``params`` is an unsharded :class:`stacked.StackedModelParams` with w4a8
    projections, on ``device``; the constructor fuses (``fused=True``),
    int8-quantizes the factors and the head, and keeps this rank's shard.
    ``fused=True`` implies the head-major int8 cache (``kv_int8`` is
    ignored); ``flash_attn`` prefills through the flash prefill kernel (the
    reference's engine prefills with the plain attention) and, as on
    :class:`FastServingEngine`, needs ``fused=True``. ``fused=False``
    serves the stacked step with bf16 or int8 token-major KV per
    ``kv_int8``.
    """

    def __init__(self, params: stacked.StackedModelParams,
                 config: ModelConfig, mesh, axis: str = "tp",
                 max_slots: int = 8, max_seq_len: Optional[int] = None,
                 seed: int = 0, kv_int8: bool = False, fused: bool = True,
                 flash_attn: bool = False, device="cuda"):
        self.mesh, self.axis, self.fused = mesh, axis, fused
        self.group = comm.axis_group(mesh, axis)
        self._local_cfg = tpd._local_config(config,
                                            comm.axis_size(mesh, axis))
        if fused:
            fp = _fused_params(params)
            params = tpf.shard_fused_model_tp(fp, mesh, axis)
        else:
            params = tpd.shard_stacked_model_tp(params, mesh, axis)
        # the base class creates the cache (_create_cache) at the local
        # config's heads; its stacked check takes this rank's shard
        super().__init__(params, config, max_slots=max_slots,
                         max_seq_len=max_seq_len, seed=seed,
                         kv_int8=kv_int8 and not fused,
                         flash_attn=flash_attn, device=device)

    def _create_cache(self):
        args = (self._local_cfg, self.max_slots, self.max_seq_len)
        if self.fused:
            return llama.HeadMajorQuantKVCache.create(*args,
                                                      device=self.device)
        if self._kv_int8:
            return llama.QuantKVCache.create(*args, device=self.device)
        return llama.KVCache.create(*args, device=self.device)

    def _prefill(self, tokens, slot: int, last_pos: int):
        if self.fused:
            return tpf.prefill_into_slot_fused_tp(
                self.params, tokens, slot, self.cache, self.config,
                self.mesh, self.axis, last_pos=last_pos,
                flash=self._flash)
        return tpd.prefill_into_slot_w4a8_tp(
            self.params, tokens, slot, self.cache, self.config, self.mesh,
            self.axis, last_pos=last_pos)

    def _decode(self) -> None:
        tokens, pos = self._batch()
        if self.fused:
            # continuous batching decodes slots at ragged positions: the
            # per-row staged commit
            logits, self.cache = tpf.decode_step_fused_tp(
                self.params, tokens, pos, self.cache, self.config,
                self.mesh, self.axis, staged_kv=True)
        else:
            logits, self.cache = tpd.decode_step_w4a8_tp(
                self.params, tokens, pos, self.cache, self.config,
                self.mesh, self.axis)
        self._advance(logits)

    def _sample(self, logits, temperature, top_k=0, top_p=1.0):
        """The group's rank 0 samples; every rank takes its tokens."""
        if comm.group_rank(self.group) == 0:
            tokens = super()._sample(logits, temperature, top_k, top_p)
        else:
            tokens = torch.empty(logits.shape[0], dtype=torch.int32,
                                 device=logits.device)
        return comm.broadcast(tokens.contiguous(), self.group, 0)


def _fused_params(params: stacked.StackedModelParams):
    """Fused w4a8 params with int8 factors and an int8 head, as the
    reference's engine builds them."""
    return fused.quantize_factors_int8_fused(fused.fuse_stacked(params))
