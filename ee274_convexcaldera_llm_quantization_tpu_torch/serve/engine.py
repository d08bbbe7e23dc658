"""Serving engine: continuous batching over a slotted KV cache.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.serve.engine``:

- a fixed pool of ``max_slots`` batch slots backed by one KV cache on the
  device;
- a host-side scheduler: admit queued requests into free slots (prefill one
  sequence into its slot), then run batched decode steps over all active
  slots with per-slot positions;
- greedy or temperature / top-k / top-p sampling from a seeded
  ``torch.Generator``; per-slot EOS / max-token termination;
- requests arrive and retire continuously: a finishing sequence frees its
  slot for the next queued prompt without stopping the batch.

This class serves ``llama.ModelParams`` (dense or compressed projections
in either serving mode) on the reference's own path: a bf16
:class:`llama.KVCache`, prompts prefilled through
``llama.prefill_into_slot`` in power-of-two buckets, decode ticks through
``llama.decode_step_batched``. :class:`serve.fast_engine.FastServingEngine`
overrides the cache and both steps for the stacked and fused W4A8 paths.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import sampling


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 64
    temperature: float = 0.0            # 0 => greedy
    top_k: int = 0                      # 0 => disabled
    top_p: float = 1.0                  # 1 => disabled
    eos_token: Optional[int] = None
    priority: int = 0                   # higher admits first (paged engine)
    tenant: int = 0                     # fair-share accounting id


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    prompt_len: int
    finished_reason: str                # "eos" | "length"
    latency_s: float = 0.0


@dataclasses.dataclass
class _Slot:
    req: Request
    pos: int                            # next write position in the cache
    generated: List[int]
    start_time: float


class ServingEngine:
    """Continuous-batching scheduler over a fixed slot pool.

    ``params``: :class:`llama.ModelParams` on ``device``, which is where
    the cache lives and the steps run ("cuda" by default; "cpu" runs the
    plain PyTorch versions of the kernels). Subclasses may replace the
    cache (:meth:`_create_cache`) and the model path (:meth:`_admit`,
    :meth:`_decode`).
    """

    def __init__(self, params, config: ModelConfig, max_slots: int = 8,
                 max_seq_len: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        self.params = params
        self.config = config
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len or config.max_seq_len
        self.device = resolve_device(device)
        self.cache = self._create_cache()
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: Dict[int, _Slot] = {}
        self.free_slots = list(range(max_slots))[::-1]
        self.completions: List[Completion] = []
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.steps = 0
        self.tokens_generated = 0

    # -- public API ---------------------------------------------------------

    def validate(self, req: Request) -> None:
        """Raise ValueError if the request can never be served (pure read)."""
        if len(req.prompt) + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request {req.uid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens exceeds max_seq_len "
                f"{self.max_seq_len}")

    def submit(self, req: Request) -> None:
        self.validate(req)
        self.queue.append(req)

    def busy(self) -> bool:
        """Work pending? (generic engine interface for an HTTP runner)."""
        return bool(self.queue or self.slots or self._pending())

    def live_generated(self):
        """uid -> tokens committed so far for in-flight requests."""
        return {st.req.uid: st.generated for st in self.slots.values()}

    def run(self, max_steps: Optional[int] = None) -> List[Completion]:
        """Run until every submitted request completes."""
        steps = 0
        while self.busy() and (max_steps is None or steps < max_steps):
            self.step()
            steps += 1
        done, self.completions = self.completions, []
        return done

    def step(self) -> None:
        """One scheduler tick: admit + one batched decode step."""
        self._admit()
        if self.slots:
            self._decode()
        self.steps += 1

    # -- model path (subclasses) --------------------------------------------

    def _create_cache(self):
        return llama.KVCache.create(self.config, self.max_slots,
                                    self.max_seq_len, device=self.device)

    def _admit(self) -> None:
        """Prefill queued prompts into free slots, each right-padded to its
        bucket, logits taken at the prompt's last position."""
        while self.queue and self.free_slots:
            req = self.queue.popleft()
            slot = self.free_slots.pop()
            n = len(req.prompt)
            tokens = self._padded(req.prompt, min(self._bucket(n),
                                                  self.max_seq_len))
            logits, self.cache = self._prefill(tokens, slot, n - 1)
            self._start(slot, req, logits)

    def _prefill(self, tokens: torch.Tensor, slot: int, last_pos: int):
        """Prefill one bucketed prompt (1, S) into ``slot``; returns
        ``(logits at last_pos, cache)``."""
        return llama.prefill_into_slot(self.params, tokens, slot, self.cache,
                                       self.config, last_pos=last_pos)

    def _decode(self) -> None:
        """One batched decode step over every slot (free slots run masked
        at position 0 and their output is dropped)."""
        tokens, pos = self._batch()
        logits, self.cache = llama.decode_step_batched(
            self.params, tokens, pos, self.cache, self.config)
        self._advance(logits)

    def _pending(self) -> bool:
        """Extra in-flight work beyond queue/slots (subclass hook, e.g.
        partially prefilled chunked prompts)."""
        return False

    # -- scheduler internals ------------------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        """Round a prompt length up to a power of two (at least 8), which
        bounds the number of distinct prefill shapes at log2(max_seq_len)."""
        b = 8
        while b < n:
            b *= 2
        return b

    def _padded(self, tokens, length: int) -> torch.Tensor:
        """``tokens`` right-padded with token 0 to ``length``, (1, length)
        on the device. A prompt pads to its bucket: pad K/V beyond the real
        prompt is causally invisible (decode at position p attends <= p,
        and each step overwrites its pad column before exposing it)."""
        padded = np.zeros(length, np.int64)
        padded[:len(tokens)] = tokens
        return torch.from_numpy(padded)[None].to(self.device)

    def _batch(self, parked=None):
        """(tokens, pos) of every slot, (max_slots,) on the device. Slots
        that are not live decode token 0 and their output is dropped, but
        the step still writes their K/V at their position: free slots sit at
        position 0 (a prefill overwrites it), the slots in ``parked`` (slot
        -> position) at the position given."""
        tokens = np.zeros(self.max_slots, np.int64)
        pos = np.zeros(self.max_slots, np.int32)
        for s, p in (parked or {}).items():
            pos[s] = p
        for s, st in self.slots.items():
            tokens[s] = st.generated[-1]
            pos[s] = st.pos
        return (torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(pos).to(self.device))

    def _start(self, slot: int, req: Request, logits: torch.Tensor) -> None:
        """Sample a prefilled request's first token and make it live."""
        tok = int(self._sample(logits[None, :], req.temperature, req.top_k,
                               req.top_p)[0])
        self.slots[slot] = _Slot(req=req, pos=len(req.prompt),
                                 generated=[tok], start_time=time.time())
        self.tokens_generated += 1
        self._maybe_finish(slot)

    def _advance(self, logits: torch.Tensor) -> None:
        """Sample every live slot's next token from a decode step's
        (max_slots, vocab) logits."""
        temps = np.zeros(self.max_slots, np.float32)
        ks = np.zeros(self.max_slots, np.int64)
        ps = np.ones(self.max_slots, np.float32)
        for s, st in self.slots.items():
            temps[s] = st.req.temperature
            ks[s] = st.req.top_k
            ps[s] = st.req.top_p
        sampled = self._sample(logits, temps, ks, ps).tolist()
        for s in list(self.slots):
            st = self.slots[s]
            st.generated.append(int(sampled[s]))
            st.pos += 1
            self.tokens_generated += 1
            self._maybe_finish(s)

    def _sample(self, logits, temperature, top_k=0, top_p=1.0):
        """Greedy when temperature <= 0, else temperature sampling with
        optional per-row top-k / top-p filtering (see serve.sampling)."""
        dev = logits.device
        return sampling.sample_logits(
            self._gen, logits,
            torch.as_tensor(np.atleast_1d(temperature), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.atleast_1d(top_k), dtype=torch.int64,
                            device=dev),
            torch.as_tensor(np.atleast_1d(top_p), dtype=torch.float32,
                            device=dev))

    def _maybe_finish(self, slot: int) -> None:
        st = self.slots[slot]
        req = st.req
        reason = None
        if req.eos_token is not None and st.generated[-1] == req.eos_token:
            reason = "eos"
        elif len(st.generated) >= req.max_new_tokens:
            reason = "length"
        if reason:
            self.completions.append(Completion(
                uid=req.uid, tokens=list(st.generated),
                prompt_len=len(req.prompt), finished_reason=reason,
                latency_s=time.time() - st.start_time))
            del self.slots[slot]
            self.free_slots.append(slot)
