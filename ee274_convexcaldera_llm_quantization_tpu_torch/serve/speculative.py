"""Speculative decoding on the W4A8 serving paths, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.serve.
speculative``. A cheap draft model proposes ``gamma`` tokens one step at a
time; the target scores all ``gamma + 1`` positions in one multi-token
verify step (:func:`verify_step_fused`, or :func:`verify_step_mixed` for a
mixed-precision target), which reads the packed weights once for the whole
window. Speculative-sampling acceptance (Leviathan et al. / Chen et al.)
makes the emitted stream distributed exactly as the target's: draft token
``i`` is accepted with probability ``min(1, p_i / q_i)`` and the first
rejection is redrawn from the residual ``max(p - q, 0)``; greedy rows reduce
to longest-prefix matching.

- The verify step writes the K/V of all ``S`` window positions of row ``b``
  at columns ``pos[b] .. pos[b] + S - 1`` first, then attends with each
  query ``i`` masked to ``j <= pos[b] + i`` (the plain attention, over all
  three cache kinds). Rejected columns are never purged: every later step
  writes a column before any query can attend it.
- JAX's ``dynamic_update_slice`` clamps a window that runs past the cache
  and so overwrites valid K/V; here such a window raises ``ValueError``
  (:func:`_check_window`; ROADMAP R15). ``validate`` of the speculative
  engine keeps ``gamma`` columns of headroom.
- The draft runs ``gamma + 1`` steps: the last proposes nothing and only
  writes the draft's K/V of the last drafted token, so that a fully
  accepted window leaves the draft cache complete.
- Draws come from an explicit ``torch.Generator`` on the logits' device.
  :func:`speculative_accept_draws` takes the draws themselves (the
  uniforms and the Gumbel noise of the residual draw, as
  ``jax.random.categorical`` is Gumbel-max), so the same draws give the
  reference's answer; :func:`speculative_accept` draws them.

On the card the verify step runs the W4A8 kernels at M = B * S (the stacked
kernel's tile path above M 8; the L- or LR-fused kernels for fused params
quantized on those factor paths) and the int8 head at M = B * S; the draft
runs its own decode step's kernels.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    fused, llama, mixed, stacked)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    HeadMajorQuantKVCache, KVCache)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import sampling


# ---------------------------------------------------------------------------
# multi-token verify step


def _check_window(pos: torch.Tensor, S: int, T: int) -> None:
    """Raise unless every row's window ``pos[b] .. pos[b] + S - 1`` lies in
    the cache's ``T`` columns (reads ``pos`` back to the host)."""
    last = int(pos.max()) + S
    if last > T or int(pos.min()) < 0:
        raise ValueError(
            f"verify window of {S} tokens at positions {pos.tolist()} runs "
            f"past the cache's {T} columns: keep at least gamma + 1 = {S} "
            "columns of headroom past the last committed token (the "
            "reference's clamped write would overwrite valid K/V; ROADMAP "
            "R15)")


def _cache_len(cache) -> int:
    return cache.k.shape[3 if isinstance(cache, HeadMajorQuantKVCache)
                         else 2]


def _verify_setup(params, tokens, pos, cache, config):
    """Embeddings, RoPE tables, the (B, 1, 1, S, T) mask and the window's
    cache columns (B, S) of a verify step, after the window check."""
    fused._check_cache(cache)
    resolve_device(tokens.device)
    B, S = tokens.shape
    T = _cache_len(cache)
    _check_window(pos, S, T)
    dev = tokens.device
    positions = pos.long()[:, None] + torch.arange(S, device=dev)[None, :]
    cos, sin = llama.rope_tables(config, positions)
    mask = llama._mask(torch.arange(T, device=dev)[None, None, :]
                       <= positions[:, :, None])[:, None, None]
    x = params.embed[tokens].float()
    return x, cos, sin, mask, positions


def _window_attention(cache, l: int, q, k, v, positions, mask,
                      config: ModelConfig) -> torch.Tensor:
    """Write layer ``l``'s K/V of every row's window at its columns
    ``positions`` (B, S) (int8-quantized for the int8 caches), then attend
    the whole cache row under ``mask``. Returns (B, S, q_dim)."""
    B, S = positions.shape
    rows = torch.arange(B, device=positions.device)[:, None]
    if isinstance(cache, KVCache):
        cache.k[l][rows, positions] = k.to(cache.k.dtype)
        cache.v[l][rows, positions] = v.to(cache.v.dtype)
        attn = llama._attention(q, cache.k[l], cache.v[l], mask)
        return attn.reshape(B, S, config.q_dim)
    kq, ksc = llama.quantize_kv(k)          # (B, S, KVH, D), (B, S, KVH)
    vq, vsc = llama.quantize_kv(v)
    if isinstance(cache, HeadMajorQuantKVCache):
        # advanced indices on dims 0 and 2 lead: (B, S, KVH[, D])
        cache.k[l][rows, :, positions] = kq
        cache.v[l][rows, :, positions] = vq
        cache.k_scale[l][rows, :, positions] = ksc
        cache.v_scale[l][rows, :, positions] = vsc
        attn = llama._attention_q8(
            q, cache.k[l].transpose(1, 2), cache.v[l].transpose(1, 2),
            cache.k_scale[l].transpose(1, 2), cache.v_scale[l].transpose(1, 2),
            mask)
    else:
        cache.k[l][rows, positions] = kq
        cache.v[l][rows, positions] = vq
        cache.k_scale[l][rows, positions] = ksc
        cache.v_scale[l][rows, positions] = vsc
        attn = llama._attention_q8(q, cache.k[l], cache.v[l],
                                   cache.k_scale[l], cache.v_scale[l], mask)
    return attn.reshape(B, S, config.q_dim)


def _window_logits(params, x: torch.Tensor, config: ModelConfig):
    B, S, h = x.shape
    return llama._logits(x.reshape(B * S, h), params.embed, params.final_norm,
                         params.lm_head, config).reshape(B, S, -1)


def verify_step_fused(params: fused.FusedStackedParams, tokens: torch.Tensor,
                      pos: torch.Tensor, cache, config: ModelConfig):
    """Score an ``S``-token window per row in one fused-path forward.

    ``tokens`` (B, S): token ``i`` of row ``b`` sits at position ``pos[b] +
    i``. The K/V of every window position are written into ``cache`` (a
    bf16 :class:`llama.KVCache`, an int8 :class:`llama.QuantKVCache` or a
    :class:`llama.HeadMajorQuantKVCache`; in place). Returns ``(logits (B,
    S, vocab) f32, cache)``: ``logits[b, i]`` is the target's next-token
    distribution after ``tokens[b, :i + 1]``. Raises ``ValueError`` when a
    window runs past the cache (R15).
    """
    lp = params.layers
    B, S = tokens.shape
    h, D = config.hidden_size, config.head_dim
    x, cos, sin, mask, positions = _verify_setup(params, tokens, pos, cache,
                                                 config)
    for l in range(config.num_layers):
        y = llama.rms_norm(x, lp.attn_norm[l],
                           config.rms_norm_eps).reshape(B * S, h)
        q, k, v = fused._apply_fused(lp.qkv, l, y)
        q = llama.apply_rope(q.reshape(B, S, config.num_heads, D), cos, sin)
        k = llama.apply_rope(k.reshape(B, S, config.num_kv_heads, D), cos,
                             sin)
        v = v.reshape(B, S, config.num_kv_heads, D)
        attn = _window_attention(cache, l, q, k, v, positions, mask, config)
        x = x + fused._apply_plain(lp.o_proj, l, attn.reshape(
            B * S, config.q_dim)).reshape(B, S, h)
        y = llama.rms_norm(x, lp.mlp_norm[l],
                           config.rms_norm_eps).reshape(B * S, h)
        gate, up = fused._apply_fused(lp.gateup, l, y)
        x = x + fused._apply_plain(lp.down_proj, l, gate * torch.sigmoid(gate)
                                   * up).reshape(B, S, h)
    return _window_logits(params, x, config), cache


def verify_step_mixed(params: mixed.MixedStackedParams, tokens: torch.Tensor,
                      pos: torch.Tensor, cache: HeadMajorQuantKVCache,
                      config: ModelConfig):
    """:func:`verify_step_fused` for a mixed-precision target: every
    projection through its bucket (the segmented decode's structure, one
    run of one signature after another), the same verify math.
    Head-major int8 caches only (the flagship's serving cache)."""
    if not isinstance(cache, HeadMajorQuantKVCache):
        raise ValueError("verify_step_mixed requires a "
                         "HeadMajorQuantKVCache")
    lp = params.layers
    B, S = tokens.shape
    h, D = config.hidden_size, config.head_dim
    x, cos, sin, mask, positions = _verify_setup(params, tokens, pos, cache,
                                                 config)
    for start, end, sig in mixed.mixed_segments(lp, config.num_layers):
        for l in range(start, end):
            def apply(name, y, l=l):
                mp = getattr(lp, name)
                return mixed._apply_bucket(mp.buckets[sig[name]],
                                           mp.index_in_static[l], y)
            y = llama.rms_norm(x, lp.attn_norm[l],
                               config.rms_norm_eps).reshape(B * S, h)
            q = llama.apply_rope(apply("q_proj", y).reshape(
                B, S, config.num_heads, D), cos, sin)
            k = llama.apply_rope(apply("k_proj", y).reshape(
                B, S, config.num_kv_heads, D), cos, sin)
            v = apply("v_proj", y).reshape(B, S, config.num_kv_heads, D)
            attn = _window_attention(cache, l, q, k, v, positions, mask,
                                     config)
            x = x + apply("o_proj", attn.reshape(B * S, config.q_dim)
                          ).reshape(B, S, h)
            y = llama.rms_norm(x, lp.mlp_norm[l],
                               config.rms_norm_eps).reshape(B * S, h)
            gate, up = apply("gate_proj", y), apply("up_proj", y)
            x = x + apply("down_proj", gate * torch.sigmoid(gate) * up
                          ).reshape(B, S, h)
    return _window_logits(params, x, config), cache


def _verify_step(params, tokens, pos, cache, config):
    """The multi-token verify of the target's parameterization."""
    if isinstance(params, mixed.MixedStackedParams):
        return verify_step_mixed(params, tokens, pos, cache, config)
    return verify_step_fused(params, tokens, pos, cache, config)


# ---------------------------------------------------------------------------
# draft dispatch + sampling distributions


def _draft_decode(draft_params, tokens, pos, dcache, dconfig):
    """One draft decode step on the draft's parameterization: mixed
    (segmented), fused, stacked W4A8, or per-layer ``llama.ModelParams``."""
    if isinstance(draft_params, mixed.MixedStackedParams):
        return mixed.decode_step_mixed_segmented(draft_params, tokens, pos,
                                                 dcache, dconfig)
    if isinstance(draft_params, fused.FusedStackedParams):
        return fused.decode_step_fused(draft_params, tokens, pos, dcache,
                                       dconfig)
    if isinstance(draft_params, stacked.StackedModelParams):
        return stacked.decode_step_w4a8(draft_params, tokens, pos, dcache,
                                        dconfig)
    return llama.decode_step_batched(draft_params, tokens, pos, dcache,
                                     dconfig)


def _draft_prefill(draft_params, tokens, slot, dcache, dconfig):
    """Prefill one prompt into the draft's cache (see
    :func:`_draft_decode`)."""
    if isinstance(draft_params, mixed.MixedStackedParams):
        return mixed.prefill_into_slot_mixed(draft_params, tokens, slot,
                                             dcache, dconfig)
    if isinstance(draft_params, fused.FusedStackedParams):
        return fused.prefill_into_slot_fused(draft_params, tokens, slot,
                                             dcache, dconfig)
    if isinstance(draft_params, stacked.StackedModelParams):
        return stacked.prefill_into_slot_w4a8(draft_params, tokens, slot,
                                              dcache, dconfig)
    return llama.prefill_into_slot(draft_params, tokens, slot, dcache,
                                   dconfig)


def _dist(logits: torch.Tensor, temperature, top_k, top_p) -> torch.Tensor:
    """Per-row sampling distribution: the softmax of the filtered logits
    for ``temperature > 0`` rows, the one-hot argmax for greedy rows (so
    greedy acceptance is the exact longest-prefix-match case of rejection
    sampling)."""
    B, V = logits.shape
    temperature = sampling._per_row(temperature, B, torch.float32,
                                    logits.device)
    soft = torch.softmax(sampling.filter_logits(logits, temperature, top_k,
                                                top_p), dim=-1)
    hard = torch.nn.functional.one_hot(logits.argmax(dim=-1), V).float()
    return torch.where((temperature > 0)[:, None], soft, hard)


def speculative_accept_draws(d: torch.Tensor, q_dists: torch.Tensor,
                             p_dists: torch.Tensor, u: torch.Tensor,
                             gumbel: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative-sampling acceptance on explicit draws.

    ``d`` (B, gamma): draft tokens, ``d[:, i]`` drawn from ``q_dists[:, i]``
    (B, gamma, V); ``p_dists`` (B, gamma + 1, V): the target's distribution
    after each accepted prefix (row ``gamma`` = the bonus). ``u`` (B,
    gamma): uniforms in [0, 1); ``gumbel`` (B, V): standard Gumbel noise.

    Returns ``(n_acc (B,), next_token (B,))``: draft ``i`` is accepted when
    ``u * q_i(d_i) < p_i(d_i)``; the token after the accepted prefix is the
    Gumbel-max draw from the residual ``max(p - q, 0)`` at the first
    rejection (``p`` where the residual has no mass), or from the bonus row
    when all ``gamma`` survive. The emitted stream's marginal is ``p``
    (Leviathan et al. 2023, thm. 1); one-hot rows reduce to greedy
    longest-prefix matching.
    """
    B, gamma, V = q_dists.shape
    p_d = torch.gather(p_dists[:, :gamma], 2, d[..., None].long())[..., 0]
    q_d = torch.gather(q_dists, 2, d[..., None].long())[..., 0]
    accept = u * q_d < p_d                 # u < p/q without the divide
    n_acc = torch.cumprod(accept.int(), dim=1).sum(dim=1)
    rows = torch.arange(B, device=d.device)
    row_p = p_dists[rows, n_acc]
    q_pad = torch.cat([q_dists, q_dists.new_zeros((B, 1, V))], dim=1)
    resid = (row_p - q_pad[rows, n_acc]).clamp_min(0.0)
    mass = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(mass > 1e-9, resid / mass.clamp_min(1e-30), row_p)
    nxt = (torch.log(resid + 1e-30) + gumbel).argmax(dim=-1)
    return n_acc, nxt.to(torch.int32)


def speculative_accept(d: torch.Tensor, q_dists: torch.Tensor,
                       p_dists: torch.Tensor, generator: torch.Generator
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`speculative_accept_draws` with the uniforms and the Gumbel
    noise (``-log(-log(U))``, ``U`` floored at the smallest normal f32, as
    ``jax.random.gumbel`` draws it) taken from ``generator``."""
    B, gamma, V = q_dists.shape
    dev = q_dists.device
    u = torch.rand((B, gamma), generator=generator, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    U = torch.rand((B, V), generator=generator, device=dev).clamp_min(tiny)
    return speculative_accept_draws(d, q_dists, p_dists, u,
                                    -torch.log(-torch.log(U)))


# ---------------------------------------------------------------------------
# one speculative round


def spec_decode_round(params, draft_params, tokens: torch.Tensor,
                      pos: torch.Tensor, cache, draft_cache,
                      generator: torch.Generator, temperature, top_k, top_p,
                      config: ModelConfig,
                      draft_config: Optional[ModelConfig] = None,
                      gamma: int = 4, pad_id: int = 0):
    """One draft-then-verify round over a continuous batch.

    ``tokens`` (B,): each row's last committed token, at position ``pos``
    (B,) (the convention of ``decode_step_fused``); ``temperature``,
    ``top_k``, ``top_p`` per row or scalars; sampled rows' draft tokens,
    the acceptance uniforms and the residual's Gumbel noise are drawn from
    ``generator``. Both caches must hold the
    round's ``gamma + 1`` columns from ``pos`` (``ValueError`` otherwise,
    before anything is written; R15). Returns ``(out_tokens (B,
    gamma + 1), n_new (B,), next_tokens (B,), new_pos (B,), cache,
    draft_cache)``: row ``b`` emits ``out_tokens[b, :n_new[b]]`` (``1 <=
    n_new <= gamma + 1``), the rest ``pad_id``. The emitted stream is
    distributed as target-only decoding; greedy rows emit the target's
    greedy stream wherever the verify step and the decode step attend alike
    (the token-major caches; ROADMAP R16).
    """
    dconfig = config if draft_config is None else draft_config
    B = tokens.shape[0]
    dev = tokens.device
    # both caches take the round's gamma + 1 columns from pos (R15), checked
    # before the draft writes any
    for c in (cache, draft_cache):
        _check_window(pos, gamma + 1, _cache_len(c))
    temperature = sampling._per_row(temperature, B, torch.float32, dev)
    top_k = sampling._per_row(top_k, B, torch.int64, dev)
    top_p = sampling._per_row(top_p, B, torch.float32, dev)

    # draft: gamma proposals, then one step that only writes the draft's
    # K/V of the last proposal
    tok, p_i, d_toks, q_list = tokens, pos, [], []
    for i in range(gamma + 1):
        logits, draft_cache = _draft_decode(draft_params, tok, p_i,
                                            draft_cache, dconfig)
        if i == gamma:
            break
        q_list.append(_dist(logits, temperature, top_k, top_p))
        tok = sampling.sample_logits(generator, logits, temperature, top_k,
                                     top_p).to(tokens.dtype)
        d_toks.append(tok)
        p_i = p_i + 1
    d = torch.stack(d_toks, dim=1)                          # (B, gamma)
    q_dists = torch.stack(q_list, dim=1)                    # (B, gamma, V)

    # verify: one multi-token target forward
    S = gamma + 1
    window = torch.cat([tokens[:, None], d], dim=1)         # (B, S)
    logits, cache = _verify_step(params, window, pos, cache, config)
    V = logits.shape[-1]
    p_dists = _dist(logits.reshape(B * S, V),
                    temperature.repeat_interleave(S),
                    top_k.repeat_interleave(S),
                    top_p.repeat_interleave(S)).reshape(B, S, V)

    n_acc, nxt = speculative_accept(d, q_dists, p_dists, generator)

    ar = torch.arange(S, device=dev)[None, :]
    d_pad = torch.cat([d, d.new_zeros((B, 1))], dim=1)
    out = torch.where(ar < n_acc[:, None], d_pad,
                      torch.where(ar == n_acc[:, None],
                                  nxt[:, None].to(d.dtype),
                                  torch.full_like(d_pad, pad_id)))
    n_new = n_acc + 1
    return (out, n_new, nxt.to(tokens.dtype), pos + n_new.to(pos.dtype),
            cache, draft_cache)


# ---------------------------------------------------------------------------
# helpers


def truncate_draft(params, config: ModelConfig,
                   n_layers: int) -> Tuple[object, ModelConfig]:
    """Early-exit self-draft: the target's first ``n_layers`` blocks with
    the shared embedding, final norm and head (views, no extra weight
    memory). Quality depends on the checkpoint; the rejection sampler keeps
    the output exact regardless."""
    if isinstance(params, mixed.MixedStackedParams):
        new = mixed.truncate_mixed(params, n_layers)
    elif isinstance(params, llama.ModelParams):
        new = dataclasses.replace(params,
                                  layers=list(params.layers[:n_layers]))
    else:
        new = dataclasses.replace(params, layers=stacked._map_leaves(
            lambda t: t[:n_layers], params.layers))
    return new, dataclasses.replace(config, num_layers=n_layers)


def generate_speculative(params, draft_params, prompts: torch.Tensor,
                         max_new_tokens: int, config: ModelConfig,
                         draft_config: Optional[ModelConfig] = None,
                         gamma: int = 4, temperature: float = 0.0,
                         top_k: int = 0, top_p: float = 1.0,
                         max_len: Optional[int] = None,
                         cache_factory=KVCache.create,
                         draft_cache_factory=None,
                         generator: Optional[torch.Generator] = None,
                         eos_id: Optional[int] = None) -> List[List[int]]:
    """Host-side speculative generation loop (tests, examples, bench).

    ``prompts``: (B, S0) equal-length tokens on the params' device; the
    caches come from ``cache_factory(config, B, max_len, device=...)`` (and
    ``draft_cache_factory``, bf16 :class:`llama.KVCache` when None). Draws
    come from ``generator`` (one seeded with 0 on the prompts' device when
    None). Returns B lists of ``max_new_tokens`` generated ids, each cut
    after ``eos_id`` if given.
    """
    dconfig = config if draft_config is None else draft_config
    if draft_cache_factory is None:
        draft_cache_factory = KVCache.create
    dev = resolve_device(prompts.device)
    B, S0 = prompts.shape
    # a round can run the verify window past the final emitted token
    if max_len is None:
        max_len = S0 + max_new_tokens + 2 * (gamma + 1)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    cache = cache_factory(config, B, max_len, device=dev)
    dcache = draft_cache_factory(dconfig, B, max_len, device=dev)

    first = []
    for b in range(B):
        if isinstance(params, mixed.MixedStackedParams):
            lg, cache = mixed.prefill_into_slot_mixed(
                params, prompts[b:b + 1], b, cache, config)
        else:
            lg, cache = fused.prefill_into_slot_fused(
                params, prompts[b:b + 1], b, cache, config)
        first.append(lg)
        _, dcache = _draft_prefill(draft_params, prompts[b:b + 1], b, dcache,
                                   dconfig)
    temp = torch.full((B,), float(temperature), device=dev)
    tk = torch.full((B,), int(top_k), dtype=torch.int64, device=dev)
    tp = torch.full((B,), float(top_p), device=dev)
    tokens = sampling.sample_logits(generator, torch.stack(first), temp, tk,
                                    tp).to(prompts.dtype)
    pos = torch.full((B,), S0, dtype=torch.int32, device=dev)

    emitted = [[t] for t in tokens.tolist()]
    pos_h, S = [S0] * B, gamma + 1
    while min(len(e) for e in emitted) < max_new_tokens:
        out, n_new, tokens, _, cache, dcache = spec_decode_round(
            params, draft_params, tokens, pos, cache, dcache, generator,
            temp, tk, tp, config, dconfig, gamma=gamma)
        for b, (e, row, n) in enumerate(zip(emitted, out.tolist(),
                                            n_new.tolist())):
            e.extend(row[:n])
            pos_h[b] += n
            # a row that is done can run ahead of the slowest one past the
            # cache; its later rounds are dropped, so it rewrites the last
            # columns (what the reference's clamped writes do) instead
            if len(e) >= max_new_tokens and pos_h[b] + S > max_len:
                pos_h[b] = max_len - S
        pos = torch.tensor(pos_h, dtype=torch.int32, device=dev)
    result = []
    for e in emitted:
        e = e[:max_new_tokens]
        if eos_id is not None and eos_id in e:
            e = e[:e.index(eos_id) + 1]
        result.append(e)
    return result
