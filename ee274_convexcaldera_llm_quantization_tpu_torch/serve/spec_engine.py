"""Continuous-batching serving engine with speculative decoding, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.serve.
spec_engine``: the slot scheduler of :class:`FastServingEngine`, where each
decode tick is one draft-then-verify round (``serve.speculative.
spec_decode_round``): up to ``gamma + 1`` tokens commit per target forward
instead of one. The output is distributed exactly as target-only decoding,
so speculative serving is a latency / throughput knob.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import speculative
from ee274_convexcaldera_llm_quantization_tpu_torch.serve.engine import (
    Request)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve.fast_engine import (
    FastServingEngine)

# weight of the previous acceptance estimate in the EWMA
_EWMA_BETA = 0.7
# a longer window must beat the best so far by this factor (hysteresis)
_GAMMA_HYSTERESIS = 1.02


class SpeculativeServingEngine(FastServingEngine):
    """Slot-pool continuous batching where decode ticks are speculative
    rounds.

    ``params`` must be fused (``fused.fuse_stacked``). ``draft_params`` may
    be fused or stacked W4A8 params (e.g. the same checkpoint compressed
    harder), a per-layer ``llama.ModelParams``, or an early-exit truncation
    (``speculative.truncate_draft``). ``draft_kv_int8`` gives the draft an
    int8 token-major cache (bf16 otherwise; the two caches are
    independent). Whole prompts are prefilled into both caches at
    admission; ``prefill_chunk`` is refused.

    ``spec_rounds`` counts rounds per live slot and ``accepted_tokens`` the
    draft tokens they accepted (mean accepted per round =
    ``accepted_tokens / spec_rounds``), the number a deployment watches to
    size ``gamma``.

    ``adaptive=True`` (default) tunes gamma online from that telemetry: an
    EWMA of per-token acceptance feeds the committed-tokens-per-cost model
    ``E[commit | a, g] / (1 + draft_cost * g)``, ``E[commit] = (1 -
    a^(g+1)) / (1 - a)``, over ``g`` in ``0 .. gamma``, switching only on a
    2% gain; ``g = 0`` means plain decode ticks, which keep the draft cache
    current (one draft step a tick) and re-probe with a one-token round
    every ``probe_every`` ticks. The emitted stream is exact either way.
    """

    def __init__(self, params, draft_params, config: ModelConfig,
                 draft_config: Optional[ModelConfig] = None, gamma: int = 4,
                 draft_kv_int8: bool = False, adaptive: bool = True,
                 draft_cost: Optional[float] = None,
                 probe_every: int = 16, **kw):
        if kw.get("prefill_chunk"):
            raise ValueError("SpeculativeServingEngine prefills whole "
                             "prompts into both caches; prefill_chunk is "
                             "not supported")
        super().__init__(params, config, **kw)
        if not self._fused:
            raise ValueError("SpeculativeServingEngine requires fused "
                             "params (fused.fuse_stacked)")
        self.draft_params = draft_params
        self.draft_config = draft_config or config
        self.gamma = int(gamma)
        cache_cls = llama.QuantKVCache if draft_kv_int8 else llama.KVCache
        self.draft_cache = cache_cls.create(self.draft_config, self.max_slots,
                                            self.max_seq_len,
                                            device=self.device)
        self.adaptive = bool(adaptive)
        if draft_cost is None:
            draft_cost = (self.draft_config.num_layers
                          / max(config.num_layers, 1))
        self.draft_cost = float(draft_cost)
        self.probe_every = int(probe_every)
        self.accept_ewma = None          # per-token acceptance estimate
        self.gamma_current = self.gamma
        self._ticks_since_spec = 0
        self.spec_rounds = 0
        self.accepted_tokens = 0

    def validate(self, req: Request) -> None:
        # the verify window writes gamma columns past the last emitted
        # token, so the cache keeps that headroom (ROADMAP R15)
        if (len(req.prompt) + req.max_new_tokens + self.gamma
                > self.max_seq_len):
            raise ValueError(
                f"request {req.uid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new + gamma {self.gamma} headroom "
                f"exceeds max_seq_len {self.max_seq_len}")

    def _prefill(self, tokens, slot: int, last_pos: int):
        # the draft keeps its own cache of the same bucketed prompt (pad
        # K/V beyond the prompt is causally invisible, as in the target's)
        out = super()._prefill(tokens, slot, last_pos)
        _, self.draft_cache = speculative._draft_prefill(
            self.draft_params, tokens, slot, self.draft_cache,
            self.draft_config)
        return out

    def _sync_draft_positions(self) -> None:
        """Keep the draft cache current during plain-decode ticks: one draft
        step writes the K/V of each live slot's previous token at ``pos -
        1`` (logits dropped). It costs ``draft_cost`` of a tick, the price
        of a meaningful re-probe (a stale draft cache would read garbage
        and measure acceptance 0 forever)."""
        tokens = np.zeros(self.max_slots, np.int64)
        pos = np.zeros(self.max_slots, np.int32)
        for s, st in self.slots.items():
            # the plain tick already appended its token and bumped pos
            tokens[s] = (st.generated[-2] if len(st.generated) > 1
                         else st.generated[-1])
            pos[s] = max(st.pos - 1, 0)
        _, self.draft_cache = speculative._draft_decode(
            self.draft_params, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos).to(self.device), self.draft_cache,
            self.draft_config)

    def _best_gamma(self) -> int:
        """argmax_g committed-per-cost under the current acceptance EWMA."""
        if self.accept_ewma is None:
            return self.gamma
        a = min(max(self.accept_ewma, 0.0), 0.999)
        best_g, best_rate = 0, 1.0       # plain decode: 1 token per cost 1
        for g in range(1, self.gamma + 1):
            rate = ((1 - a ** (g + 1)) / (1 - a)) / (1.0 + self.draft_cost * g)
            if rate > best_rate * _GAMMA_HYSTERESIS:
                best_g, best_rate = g, rate
        return best_g

    def _decode(self) -> None:
        gamma = self.gamma
        if self.adaptive:
            gamma = self.gamma_current
            if gamma == 0:
                # speculation off by telemetry: plain ticks (the target
                # cache has the verify step's layout), a probe round every
                # probe_every ticks
                self._ticks_since_spec += 1
                if self._ticks_since_spec < self.probe_every:
                    super()._decode()
                    self._sync_draft_positions()
                    return
                gamma = 1                 # the cheapest probe round
                self._ticks_since_spec = 0
        # slots that are not live are free here (no chunked prefill): they
        # decode token 0 at position 0, which their next prefill overwrites
        tokens, pos = self._batch()
        temps = np.zeros(self.max_slots, np.float32)
        ks = np.zeros(self.max_slots, np.int64)
        ps = np.ones(self.max_slots, np.float32)
        for s, st in self.slots.items():
            temps[s] = st.req.temperature
            ks[s] = st.req.top_k
            ps[s] = st.req.top_p
        out, n_new, _, _, self.cache, self.draft_cache = \
            speculative.spec_decode_round(
                self.params, self.draft_params, tokens, pos, self.cache,
                self.draft_cache, self._gen,
                torch.from_numpy(temps).to(self.device),
                torch.from_numpy(ks).to(self.device),
                torch.from_numpy(ps).to(self.device), self.config,
                self.draft_config, gamma=gamma)
        out_h, n_h = out.tolist(), n_new.tolist()
        if self.adaptive and self.slots:
            acc = float(np.mean([(n_h[s] - 1) / gamma for s in self.slots]))
            self.accept_ewma = (acc if self.accept_ewma is None else
                                _EWMA_BETA * self.accept_ewma
                                + (1 - _EWMA_BETA) * acc)
            self.gamma_current = self._best_gamma()
        for s in list(self.slots):
            st = self.slots[s]
            req = st.req
            self.spec_rounds += 1
            self.accepted_tokens += n_h[s] - 1
            for t in out_h[s][:n_h[s]]:
                st.generated.append(int(t))
                st.pos += 1
                self.tokens_generated += 1
                if req.eos_token is not None and int(t) == req.eos_token:
                    break
                if len(st.generated) >= req.max_new_tokens:
                    break
            self._maybe_finish(s)
