"""Paged serving engine: the native C++ scheduler and allocator with the
paged steps.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.serve.
paged_engine``: :mod:`serve.runtime` (page allocator, admission control,
prefix cache) with :mod:`serve.paged` (the device-side pool and steps).
Against the slotted :class:`serve.engine.ServingEngine`, KV memory is
bounded by one page pool, not ``max_slots * max_seq_len``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused, llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import paged
from ee274_convexcaldera_llm_quantization_tpu_torch.serve.engine import (
    Completion, Request, ServingEngine)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve.runtime import (
    NativeScheduler, PageAllocator)


class PagedServingEngine:
    """Paged continuous batching.

    ``params`` selects the serving path:

    - :class:`fused.FusedStackedParams` (the main path): the fused W4A8
      projections, an int8 :class:`paged.PagedQuantKVPool`, paged flash
      decode attention and one staged commit per tick. The pool carries one
      extra scratch page that the allocator never hands out: inactive
      rows' commits land there. ``flash_attn`` prefills with the flash
      prefill kernel (the reference's ``use_pallas`` on this path).
    - :class:`llama.ModelParams`: the unfused path on a bf16
      :class:`paged.PagedKVPool` (every projection through
      ``apply_linear``, the plain attention over the gathered context).

    Prompts are prefilled at their own length (no buckets). With
    ``prefix_cache`` a prompt whose page-aligned prefix is already in the
    pool shares those pages and prefills only its suffix. Sampling draws
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` ("cuda"
    by default; "cpu" runs the plain versions of the kernels).
    """

    def __init__(self, params, config: ModelConfig, max_slots: int = 8,
                 num_pages: int = 256, page_size: int = 16,
                 max_pages_per_seq: Optional[int] = None,
                 flash_attn: bool = False, seed: int = 0,
                 prefix_cache: bool = False, device="cuda"):
        self.fused = isinstance(params, fused.FusedStackedParams)
        if not self.fused and not isinstance(params, llama.ModelParams):
            raise ValueError("PagedServingEngine takes fused params "
                             "(fused.fuse_stacked) or llama.ModelParams, got "
                             f"{type(params).__name__}")
        if flash_attn and not self.fused:
            raise ValueError("flash_attn (flash prefill) requires fused "
                             "params")
        self.params = params
        self.config = config
        self.max_slots = max_slots
        self.page_size = page_size
        self.max_pages = max_pages_per_seq or (
            config.max_seq_len + page_size - 1) // page_size
        self.device = resolve_device(device)
        if self.fused:
            # one extra pool page as the inactive-row scratch target
            self.pool = paged.PagedQuantKVPool.create(
                config, num_pages + 1, page_size, device=self.device)
            self.scratch_page = num_pages
        else:
            self.pool = paged.PagedKVPool.create(config, num_pages, page_size,
                                                 device=self.device)
            self.scratch_page = None
        self.allocator = PageAllocator(num_pages, page_size)
        self.sched = NativeScheduler(max_slots, self.allocator)
        self.flash_attn = flash_attn
        self.prefix_cache = prefix_cache
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._requests: Dict[int, Request] = {}
        self._slot_of: Dict[int, int] = {}
        self._last_tok: Dict[int, int] = {}
        self._generated: Dict[int, List[int]] = {}
        self._start: Dict[int, float] = {}
        self.completions: List[Completion] = []
        self.steps = 0
        self.tokens_generated = 0

    # the slotted engine's seeded greedy / top-k / top-p sampling
    _sample = ServingEngine._sample

    def validate(self, req: Request) -> None:
        """Raise ValueError if the request can never be served (pure read)."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_pages * self.page_size:
            raise ValueError(f"request {req.uid} needs {total} tokens > "
                             f"{self.max_pages * self.page_size} capacity")
        # admission needs prompt pages + 1 decode page; a request larger
        # than the whole pool would head-of-line block the queue forever
        need = -(-len(req.prompt) // self.page_size) + 1
        if need > self.allocator.num_pages:
            raise ValueError(
                f"request {req.uid} needs {need} pages > pool size "
                f"{self.allocator.num_pages}")

    def submit(self, req: Request) -> None:
        self.validate(req)
        self._requests[req.uid] = req
        self.sched.submit(req.uid, len(req.prompt), req.max_new_tokens,
                          priority=req.priority, tenant=req.tenant)

    def run(self) -> List[Completion]:
        """Run until every submitted request completes; raise if queued
        requests can never be admitted."""
        while self.sched.queue_len or self.sched.active_count:
            queued, active = self.sched.queue_len, self.sched.active_count
            self.step()
            if (self.sched.active_count == 0 and active == 0
                    and self.sched.queue_len == queued and queued > 0):
                raise RuntimeError(
                    f"scheduler made no progress: {queued} queued requests "
                    f"cannot be admitted (pool has "
                    f"{self.allocator.free_pages} free pages)")
        done, self.completions = self.completions, []
        return done

    def busy(self) -> bool:
        """Work pending? (generic engine interface for an HTTP runner)."""
        return self.sched.queue_len > 0 or self.sched.active_count > 0

    def live_generated(self):
        """uid -> tokens committed so far for in-flight requests."""
        return {uid: toks for uid, toks in self._generated.items()
                if uid in self._slot_of}

    def step(self) -> None:
        """One scheduler tick: admit (prefill) + one batched decode step."""
        for uid, slot in self.sched.admit(create_seqs=not self.prefix_cache):
            self._admit(uid, slot)
        if self._slot_of:
            self._decode()
        self.steps += 1

    def _admit(self, uid: int, slot: int) -> None:
        req = self._requests[uid]
        self._slot_of[uid] = slot
        self._start[uid] = time.time()
        cached = 0
        if self.prefix_cache:
            # native prefix cache: page-aligned prompt prefixes already in
            # the pool are shared; prefill only the suffix
            cached = self.allocator.create_seq_cached(
                uid, np.asarray(req.prompt, np.int32))
        table = self._table(uid).to(self.device)
        prompt = torch.from_numpy(np.asarray(req.prompt, np.int64))
        tokens = prompt[cached:][None].to(self.device)
        if cached > 0:
            fn = (paged.paged_prefill_suffix_fused if self.fused
                  else paged.paged_prefill_suffix)
            logits, self.pool = fn(self.params, tokens, cached, self.pool,
                                   table, self.config)
        elif self.fused:
            logits, self.pool = paged.paged_prefill_fused(
                self.params, tokens, self.pool, table, self.config,
                flash=self.flash_attn)
        else:
            logits, self.pool = paged.paged_prefill(
                self.params, tokens, self.pool, table, self.config)
        tok = int(self._sample(logits[None, :], req.temperature, req.top_k,
                               req.top_p)[0])
        self._record(uid, tok)

    def _table(self, uid: int) -> torch.Tensor:
        """The sequence's page table padded with page 0 to max_pages."""
        pt = self.allocator.page_table(uid, self.max_pages)
        out = np.zeros(self.max_pages, np.int32)
        out[:len(pt)] = pt
        return torch.from_numpy(out)

    def _decode(self) -> None:
        uids = list(self._slot_of)
        B = self.max_slots
        tokens = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int32)
        active = np.zeros(B, bool)
        for uid in uids:
            s = self._slot_of[uid]
            tokens[s] = self._last_tok[uid]
            pos[s] = self.allocator.length(uid)      # next write position
            active[s] = True
        # reserve the write page BEFORE the device step (append allocates)
        finished = {uid: self.sched.record_token(uid, False) for uid in uids}
        tables = np.zeros((B, self.max_pages), np.int32)
        for uid in uids:
            pt = self.allocator.page_table(uid, self.max_pages)
            tables[self._slot_of[uid], :len(pt)] = pt
        dev = self.device
        args = (self.params, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(pos).to(dev), self.pool,
                torch.from_numpy(tables).to(dev), self.config)
        active_t = torch.from_numpy(active).to(dev)
        if self.fused:
            logits, self.pool = paged.paged_decode_step_fused(
                *args, active=active_t, scratch_page=self.scratch_page)
        else:
            logits, self.pool = paged.paged_decode_step(*args,
                                                        active=active_t)
        temps = np.zeros(B, np.float32)
        ks = np.zeros(B, np.int64)
        ps = np.ones(B, np.float32)
        for uid in uids:
            s = self._slot_of[uid]
            req = self._requests[uid]
            temps[s], ks[s], ps[s] = req.temperature, req.top_k, req.top_p
        sampled = self._sample(logits, temps, ks, ps).tolist()
        for uid in uids:
            req = self._requests[uid]
            tok = int(sampled[self._slot_of[uid]])
            self._generated[uid].append(tok)
            self._last_tok[uid] = tok
            self.tokens_generated += 1
            is_eos = req.eos_token is not None and tok == req.eos_token
            if (finished[uid] or is_eos
                    or len(self._generated[uid]) >= req.max_new_tokens):
                self._finish(uid, "eos" if is_eos else "length")

    def _record(self, uid: int, tok: int) -> None:
        """Record the token sampled from the prefill logits."""
        self._generated[uid] = [tok]
        self._last_tok[uid] = tok
        self.tokens_generated += 1
        req = self._requests[uid]
        is_eos = req.eos_token is not None and tok == req.eos_token
        if req.max_new_tokens <= 1 or is_eos:
            self._finish(uid, "eos" if is_eos else "length")

    def _finish(self, uid: int, reason: str) -> None:
        req = self._requests[uid]
        self.completions.append(Completion(
            uid=uid, tokens=self._generated[uid],
            prompt_len=len(req.prompt), finished_reason=reason,
            latency_s=time.time() - self._start[uid]))
        self.sched.finish(uid)
        del self._slot_of[uid]
        del self._requests[uid]
