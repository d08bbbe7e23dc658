"""Serving engine on the W4A8 fast paths.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.serve.
fast_engine``: the continuous-batching scheduler of
:class:`serve.engine.ServingEngine` with prefill and decode on
``models.fused`` (``prefill_into_slot_fused`` / ``prefill_chunk_fused`` /
``decode_step_fused``) over :class:`fused.FusedStackedParams`, or on the
unfused stacked W4A8 path (``stacked.prefill_into_slot_w4a8`` /
``decode_step_w4a8``: 7 stacked W4A8 launches per layer plus the head, on a
bf16 or int8 token-major cache) over w4a8 :class:`stacked.
StackedModelParams`.

On the card a ``flash_attn=True`` engine runs hand-written CUDA kernels
only: per prefill, 4 W4A8 launches and one flash-prefill launch per layer
plus the int8 head; per decode tick, 4 W4A8 launches and one flash-decode
launch (the row kernel, or the all-batch kernel's partition from
``max_seq_len >= 1024`` under ``attn_kernel="auto"``) per layer plus the
head. On factor path "l" the W4A8 launches are the L-fused kernel's (on
"lr", qkv and gate/up take the LR-fused kernel); ``mlp_kernel=True`` makes
a tick's gate/up and down one whole-MLP launch.
"""

from __future__ import annotations

from typing import Optional

from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    fused, llama, stacked)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve.engine import (
    ServingEngine)


class FastServingEngine(ServingEngine):
    """Continuous batching over the fused W4A8 prefill and decode steps.

    ``params``: :class:`fused.FusedStackedParams`, or a
    :class:`stacked.StackedModelParams` whose projections are all w4a8
    (``kv_int8`` only; ``flash_attn`` and ``prefill_chunk`` need fused
    params), on ``device``.

    ``flash_attn=True``: the head-major int8 cache and the flash kernels
    (flash prefill; flash decode, staged by default). ``kv_int8=True``
    (without flash): the token-major int8 :class:`llama.QuantKVCache`;
    otherwise the bf16 :class:`llama.KVCache`. ``staged_kv`` (flash only)
    defaults to True. ``attn_kernel`` "auto" takes "ab" once
    ``max_seq_len >= 1024``, else "row". ``prefill_chunk > 0`` prefills
    prompts in chunks of that size, one chunk per in-flight prompt per
    tick, interleaved with decode steps. ``mlp_kernel`` runs each fused
    decode tick's MLP as one whole-MLP kernel launch per layer (params
    quantized with factor path "l" or "lr"; the step raises otherwise).
    """

    def __init__(self, params, config: ModelConfig, max_slots: int = 8,
                 max_seq_len: Optional[int] = None, seed: int = 0,
                 kv_int8: bool = False, flash_attn: bool = False,
                 prefill_chunk: int = 0, staged_kv=None,
                 attn_kernel: str = "auto", mlp_kernel: bool = False,
                 device="cuda"):
        self._fused = isinstance(params, fused.FusedStackedParams)
        if not self._fused and (flash_attn or prefill_chunk):
            raise ValueError("flash_attn and prefill_chunk require fused "
                             "params (fused.fuse_stacked)")
        if isinstance(params, stacked.StackedModelParams):
            stacked._check_w4a8(params.layers)
        elif not self._fused:
            raise ValueError("FastServingEngine takes fused params "
                             "(fused.fuse_stacked) or w4a8 stacked params, "
                             f"got {type(params).__name__}")
        if attn_kernel not in ("auto", "row", "ab"):
            raise ValueError(f"unknown attn_kernel {attn_kernel!r}")
        self._flash = bool(flash_attn)
        self._kv_int8 = kv_int8
        self._chunk = int(prefill_chunk)
        seq_len = max_seq_len or config.max_seq_len
        if self._chunk and seq_len % self._chunk:
            raise ValueError(
                f"max_seq_len {seq_len} must be a multiple of prefill_chunk "
                f"{self._chunk} (aligned chunk writes)")
        super().__init__(params, config, max_slots=max_slots,
                         max_seq_len=max_seq_len, seed=seed, device=device)
        # continuous batching decodes at per-slot positions: the ragged-safe
        # staged commit (True), not the lockstep "uniform"
        self._staged = self._flash if staged_kv is None else staged_kv
        if attn_kernel == "auto":
            attn_kernel = "ab" if self.max_seq_len >= 1024 else "row"
        self._attn_kernel = attn_kernel
        self._mlp_kernel = mlp_kernel
        self._prefilling = {}           # slot -> [req, next_offset]

    def _create_cache(self):
        args = (self.config, self.max_slots, self.max_seq_len)
        if self._flash:
            return llama.HeadMajorQuantKVCache.create(*args,
                                                      device=self.device)
        if self._kv_int8:
            return llama.QuantKVCache.create(*args, device=self.device)
        return llama.KVCache.create(*args, device=self.device)

    def _admit(self) -> None:
        if self._chunk:
            self._admit_chunked()
        else:
            super()._admit()

    def _prefill(self, tokens, slot: int, last_pos: int):
        if self._fused:
            return fused.prefill_into_slot_fused(
                self.params, tokens, slot, self.cache, self.config,
                last_pos=last_pos, flash=self._flash)
        return stacked.prefill_into_slot_w4a8(
            self.params, tokens, slot, self.cache, self.config,
            last_pos=last_pos)

    def _pending(self) -> bool:
        return bool(self._prefilling)

    def _admit_chunked(self) -> None:
        """Chunked-prefill admission: claim free slots, then advance every
        in-flight prompt by ONE chunk per scheduler tick, so decode steps
        for active slots interleave between chunks."""
        while self.queue and self.free_slots:
            self._prefilling[self.free_slots.pop()] = [self.queue.popleft(),
                                                       0]
        C = self._chunk
        for slot in list(self._prefilling):
            req, off = self._prefilling[slot]
            n = len(req.prompt)
            end = min(off + C, n)
            chunk = self._padded(req.prompt[off:end], C)
            is_last = end >= n
            logits, self.cache = fused.prefill_chunk_fused(
                self.params, chunk, slot, off, self.cache, self.config,
                last_pos=(n - 1 - off) if is_last else 0)
            if is_last:
                del self._prefilling[slot]
                self._start(slot, req, logits)
            else:
                self._prefilling[slot][1] = end

    def _decode(self) -> None:
        # A slot between two prefill chunks decodes its dummy row at the
        # next chunk's offset: that chunk overwrites the column before
        # anything reads it. (The reference decodes it at position 0, which
        # overwrites the K/V of the prompt's first token: ROADMAP R7.)
        tokens, pos = self._batch({s: off for s, (_, off)
                                   in self._prefilling.items()})
        if self._fused:
            logits, self.cache = fused.decode_step_fused(
                self.params, tokens, pos, self.cache, self.config,
                staged_kv=self._staged if self._flash else False,
                attn_kernel=self._attn_kernel if self._flash else "row",
                mlp_kernel=self._mlp_kernel)
        else:
            logits, self.cache = stacked.decode_step_w4a8(
                self.params, tokens, pos, self.cache, self.config)
        self._advance(logits)
