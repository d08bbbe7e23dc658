"""Paged KV pools and the paged decode and prefill steps, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.serve.paged``.
The KV pool is one static-shape tensor of pages per layer; sequences own
pages through the native allocator (``serve.runtime``), and each step
receives the rows' page tables as a tensor. Context capacity is bounded by
the pool, not by ``max_slots * max_seq_len``.

- The fused W4A8 path (the serving main path): :class:`PagedQuantKVPool`
  (int8 pages in the flash kernel's head-major layout),
  :func:`paged_decode_step_fused` (the staged fused step with attention
  through the page tables: ``ops.attention.flash_decode_q8_paged``, a CUDA
  kernel on the card), :func:`paged_prefill_fused` and
  :func:`paged_prefill_suffix_fused` on ``models.fused``'s layer helpers.
- The unfused path: :class:`PagedKVPool` (bf16 pages),
  :func:`paged_decode_step`, :func:`paged_prefill` and
  :func:`paged_prefill_suffix` over per-layer ``llama.ModelParams``, every
  projection through ``compressed.apply_linear`` and the plain attention
  over the gathered context, as the reference leaves it to XLA.

The steps write the pools in place and return the same pool (the reference
returns a new one). On the card the kernels run; on the CPU their plain
versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused, llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT


@dataclasses.dataclass
class PagedQuantKVPool:
    """Paged int8 KV pool in the flash kernel's head-major layout.

    ``k``/``v``: (layers, num_pages, kv_heads, page_size, head_dim) int8
    codes; ``k_scale``/``v_scale``: (layers, num_pages, kv_heads, page_size)
    f32 per-(token, head) absmax scales: the paged twin of
    :class:`llama.HeadMajorQuantKVCache`, read by
    :func:`ops.attention.flash_decode_q8_paged` (block == page).
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @staticmethod
    def create(config: ModelConfig, num_pages: int, page_size: int,
               device="cuda") -> "PagedQuantKVPool":
        shape = (config.num_layers, num_pages, config.num_kv_heads,
                 page_size, config.head_dim)
        return PagedQuantKVPool(
            llama._zeros(shape, torch.int8, device),
            llama._zeros(shape, torch.int8, device),
            llama._zeros(shape[:-1], torch.float32, device),
            llama._zeros(shape[:-1], torch.float32, device))

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]


@dataclasses.dataclass
class PagedKVPool:
    """(layers, num_pages, page_size, kv_heads, head_dim) page pools, bf16
    by default."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(config: ModelConfig, num_pages: int, page_size: int,
               dtype=torch.bfloat16, device="cuda") -> "PagedKVPool":
        shape = (config.num_layers, num_pages, page_size,
                 config.num_kv_heads, config.head_dim)
        return PagedKVPool(llama._zeros(shape, dtype, device),
                           llama._zeros(shape, dtype, device))

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def _token_pages(page_table: torch.Tensor, positions: torch.Tensor,
                 P: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page, offset) of each logical position of one sequence."""
    positions = positions.long()
    return page_table.long()[positions // P], positions % P


# ---------------------------------------------------------------------------
# Unfused path: per-layer ModelParams, bf16 pool
# ---------------------------------------------------------------------------

def _gather_context(pool_l: torch.Tensor, page_tables: torch.Tensor):
    """One layer of a (NP, P, KVH, D) pool gathered through (B, max_pages)
    tables into the rows' logical contexts (B, max_pages * P, KVH, D)."""
    g = pool_l[page_tables.long()]
    B, n, P = g.shape[:3]
    return g.reshape(B, n * P, *g.shape[3:])


def paged_decode_step(params: llama.ModelParams, tokens: torch.Tensor,
                      pos: torch.Tensor, pool: PagedKVPool,
                      page_tables: torch.Tensor, config: ModelConfig,
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, PagedKVPool]:
    """One decode step over the paged pool.

    Each row writes its K/V into page ``page_tables[b, pos[b] // P]`` at
    offset ``pos[b] % P``, then attends its gathered logical context with
    positions ``> pos[b]`` masked. ``active`` (B,) bool: only active rows
    write (a zero-padded table row would otherwise write a free slot's
    K/V into page 0, which may be another sequence's live page; the
    reference routes those writes out of bounds, where JAX drops them).
    Returns (logits (B, vocab), pool), the pool written in place.
    """
    resolve_device(tokens.device)
    B = tokens.shape[0]
    P = pool.page_size
    T = page_tables.shape[1] * P
    dev = tokens.device
    x = params.embed[tokens][:, None, :].float()
    cos, sin = llama.rope_tables(config, pos[:, None])
    valid = torch.arange(T, device=dev)[None, :] <= pos[:, None]
    mask = llama._mask(valid)[:, None, None, None, :]
    rows = torch.arange(B, device=dev)
    p = pos.long()
    write_page = page_tables.long()[rows, p // P]
    write_off = p % P
    if active is not None:
        rows = rows[active.to(device=dev, dtype=torch.bool)]
        write_page, write_off = write_page[rows], write_off[rows]
    for l, lp in enumerate(params.layers):
        lin = llama._linears(lp)
        y = llama.rms_norm(x, lp.attn_norm, config.rms_norm_eps)
        q, k, v = llama._project_qkv(lin, y, config, cos, sin)
        ck, cv = pool.k[l], pool.v[l]
        ck[write_page, write_off] = k[rows, 0].to(ck.dtype)
        cv[write_page, write_off] = v[rows, 0].to(cv.dtype)
        attn = llama._attention(q, _gather_context(ck, page_tables),
                                _gather_context(cv, page_tables), mask)
        x = llama._mlp_and_o(lin, x, attn.reshape(B, 1, config.q_dim),
                             lp.mlp_norm, config)
    return llama._head(params, x, config)[:, 0], pool


def _prefill_unfused(params: llama.ModelParams, tokens: torch.Tensor,
                     start: int, pool: PagedKVPool, page_table: torch.Tensor,
                     config: ModelConfig, suffix: bool):
    S = tokens.shape[1]
    dev = tokens.device
    positions = start + torch.arange(S, device=dev)
    x = params.embed[tokens].float()
    cos, sin = llama.rope_tables(config, positions[None])
    if suffix:
        T = page_table.shape[0] * pool.page_size
        valid = torch.arange(T, device=dev)[None, :] <= positions[:, None]
        mask = llama._mask(valid)[None, None, None]
    else:
        mask = llama._causal(S, dev)
    pages, offs = _token_pages(page_table, positions, pool.page_size)
    for l, lp in enumerate(params.layers):
        lin = llama._linears(lp)
        y = llama.rms_norm(x, lp.attn_norm, config.rms_norm_eps)
        q, k, v = llama._project_qkv(lin, y, config, cos, sin)
        ck, cv = pool.k[l], pool.v[l]
        if suffix:
            # write the suffix first, then attend the whole logical context
            ck[pages, offs] = k[0].to(ck.dtype)
            cv[pages, offs] = v[0].to(cv.dtype)
            attn = llama._attention(q, _gather_context(ck, page_table[None]),
                                    _gather_context(cv, page_table[None]),
                                    mask)
        else:
            attn = llama._attention(q, k, v, mask)
            ck[pages, offs] = k[0].to(ck.dtype)
            cv[pages, offs] = v[0].to(cv.dtype)
        x = llama._mlp_and_o(lin, x, attn.reshape(1, S, config.q_dim),
                             lp.mlp_norm, config)
    return llama._head(params, x[:, -1:], config)[0, 0], pool


def paged_prefill(params: llama.ModelParams, tokens: torch.Tensor,
                  pool: PagedKVPool, page_table: torch.Tensor,
                  config: ModelConfig) -> Tuple[torch.Tensor, PagedKVPool]:
    """Prefill one (1, S) prompt, its causal attention over its own f32 K/V,
    writing the K/V into the sequence's pages (``page_table``
    (max_pages,)). Returns (last-position logits (vocab,), pool)."""
    resolve_device(tokens.device)
    return _prefill_unfused(params, tokens, 0, pool, page_table, config,
                            suffix=False)


def paged_prefill_suffix(params: llama.ModelParams, tokens: torch.Tensor,
                         cached_len: int, pool: PagedKVPool,
                         page_table: torch.Tensor, config: ModelConfig
                         ) -> Tuple[torch.Tensor, PagedKVPool]:
    """Prefill only the uncached (1, Sq) suffix of a prompt whose first
    ``cached_len`` (page-aligned) tokens' K/V already sit in the sequence's
    shared pages. The suffix's K/V are written first; then its queries
    attend the gathered logical context (prefix and suffix, bf16 from the
    pool) with positions beyond each query masked. Returns (logits (vocab,)
    of the prompt's last position, pool)."""
    resolve_device(tokens.device)
    return _prefill_unfused(params, tokens, int(cached_len), pool,
                            page_table, config, suffix=True)


# ---------------------------------------------------------------------------
# Fused W4A8 path: FusedStackedParams, int8 head-major pool
# ---------------------------------------------------------------------------

def _commit(pool: PagedQuantKVPool, staging, page_tables: torch.Tensor,
            pos: torch.Tensor, active: Optional[torch.Tensor],
            scratch_page: Optional[int]) -> None:
    """Write each row's staged K/V (all layers) to page
    ``page_tables[b, pos[b] // P]`` at offset ``pos[b] % P``, in place: one
    indexed write per pool tensor (``fused._commit``'s, through the page
    table). Inactive rows write ``scratch_page``, which no sequence owns."""
    sk, sks, sv, svs = staging                 # (L, B, KVH[, D])
    P = pool.page_size
    p = pos.long()
    rows = torch.arange(p.shape[0], device=p.device)
    page = page_tables.long()[rows, p // P]
    if active is not None:
        page = torch.where(active.to(device=p.device, dtype=torch.bool),
                           page, torch.full_like(page, scratch_page))
    off = p % P
    # advanced indices on dims 1 and 3 move to the front: (B, L, KVH[, D])
    pool.k[:, page, :, off] = sk.transpose(0, 1)
    pool.v[:, page, :, off] = sv.transpose(0, 1)
    pool.k_scale[:, page, :, off] = sks.transpose(0, 1)
    pool.v_scale[:, page, :, off] = svs.transpose(0, 1)


def paged_decode_step_fused(params: fused.FusedStackedParams,
                            tokens: torch.Tensor, pos: torch.Tensor,
                            pool: PagedQuantKVPool,
                            page_tables: torch.Tensor, config: ModelConfig,
                            active: Optional[torch.Tensor] = None,
                            scratch_page: Optional[int] = None,
                            tp_axis=None,
                            attn_dots: str = "f32"
                            ) -> Tuple[torch.Tensor, PagedQuantKVPool]:
    """One decode step on the fused W4A8 path over the paged pool.

    The math of ``fused.decode_step_fused(staged_kv=True)``, except that
    attention reads through the page tables
    (:func:`ops.attention.flash_decode_q8_paged`) and the end-of-step commit
    writes each row's staged K/V into page ``page_tables[b, pos[b] // P]``
    at offset ``pos[b] % P``. ``tokens`` (B,), ``pos`` (B,) int32 (the next
    write position), ``page_tables`` (B, max_pages) int, padded with 0.
    ``active`` (B,) bool masks unused rows, whose commits go to
    ``scratch_page`` (a pool page the allocator never hands out); it
    requires ``scratch_page``. ``attn_dots``: "f32" (the reference's
    default), "bf16" or "i8". ``tp_axis``: a ``torch.distributed`` group;
    params, pool and config are the rank's shard (``parallel.tp_fused``), o
    and down row-parallel as in ``fused.decode_step_fused``, and the logits
    the rank's vocabulary shard. Returns (logits (B, vocab), pool), the
    pool written in place.
    """
    fused._check_tp(params, tp_axis)
    if active is not None and scratch_page is None:
        raise ValueError("active masking requires scratch_page (size the "
                         "pool with one page the allocator never uses)")
    AT._check_dots(attn_dots)
    resolve_device(tokens.device)
    lp = params.layers
    B = tokens.shape[0]
    Lk, KVH, D = config.num_layers, config.num_kv_heads, config.head_dim
    kv_groups = config.num_heads // KVH
    dev = tokens.device
    x = params.embed[tokens].float()
    cos, sin = llama.rope_tables(config, pos[:, None])
    staging = (torch.empty((Lk, B, KVH, D), dtype=torch.int8, device=dev),
               torch.empty((Lk, B, KVH), dtype=torch.float32, device=dev),
               torch.empty((Lk, B, KVH, D), dtype=torch.int8, device=dev),
               torch.empty((Lk, B, KVH), dtype=torch.float32, device=dev))
    # the page ids once per step (a read-back to the host), not per layer
    AT._check_pages(page_tables, pool.num_pages)
    for l in range(Lk):
        q, k, v = fused._qkv(lp, l, x, cos, sin, config, (B, 1))
        kq, ksc = llama.quantize_kv(k[:, 0])
        vq, vsc = llama.quantize_kv(v[:, 0])
        for buf, val in zip(staging, (kq, ksc, vq, vsc)):
            buf[l] = val
        attn = AT._flash_decode_q8_paged(
            q[:, 0].reshape(B, KVH, kv_groups, D), pool.k, pool.v,
            pool.k_scale, pool.v_scale, kq.float() * ksc[..., None],
            vq.float() * vsc[..., None], l, page_tables, pos,
            dots=attn_dots)
        x = fused._mlp_and_o(lp, l, x, attn.reshape(B, config.q_dim), config,
                             tp_axis=tp_axis)
    _commit(pool, staging, page_tables, pos, active, scratch_page)
    return llama._logits(x, params.embed, params.final_norm, params.lm_head,
                         config), pool


def _write_pages(pool: PagedQuantKVPool, l: int, pages, offs, k, v) -> None:
    """Quantize (1, S, KVH, D) K/V and write token ``i`` at page
    ``pages[i]``, offset ``offs[i]`` of layer ``l``. The indices on dims 0
    and 2 of the (NP, KVH, P[, D]) layer are not adjacent, so their
    broadcast dimension comes first: the target is (S, KVH[, D])."""
    kq, ksc = llama.quantize_kv(k)        # (1, S, KVH, D), (1, S, KVH)
    vq, vsc = llama.quantize_kv(v)
    pool.k[l][pages, :, offs] = kq[0]
    pool.v[l][pages, :, offs] = vq[0]
    pool.k_scale[l][pages, :, offs] = ksc[0]
    pool.v_scale[l][pages, :, offs] = vsc[0]


def paged_prefill_fused(params: fused.FusedStackedParams,
                        tokens: torch.Tensor, pool: PagedQuantKVPool,
                        page_table: torch.Tensor, config: ModelConfig,
                        flash: bool = False, tp_axis=None
                        ) -> Tuple[torch.Tensor, PagedQuantKVPool]:
    """Prefill one (1, S) prompt on the fused path, writing its quantized
    K/V into the sequence's pages (``page_table`` (max_pages,)). The
    attention is the prompt's own, on its f32 K/V: the flash prefill kernel
    when ``flash``, else the plain causal attention. ``tp_axis``: as in
    :func:`paged_decode_step_fused`. Returns (last-position logits
    (vocab,), pool)."""
    fused._check_tp(params, tp_axis)
    resolve_device(tokens.device)
    lp = params.layers
    S = tokens.shape[1]
    dev = tokens.device
    positions = torch.arange(S, device=dev)
    x = params.embed[tokens[0]].float()
    cos, sin = llama.rope_tables(config, positions[None])
    mask = None if flash else llama._causal(S, dev)
    pages, offs = _token_pages(page_table, positions, pool.page_size)
    for l in range(config.num_layers):
        q, k, v = fused._qkv(lp, l, x, cos, sin, config, (1, S))
        if flash:
            attn = AT.flash_prefill(q, k, v)
        else:
            attn = llama._attention(q, k, v, mask)
        _write_pages(pool, l, pages, offs, k, v)
        x = fused._mlp_and_o(lp, l, x, attn.reshape(S, config.q_dim), config,
                             tp_axis=tp_axis)
    return fused._last_logits(params, x, None, config), pool


def paged_prefill_suffix_fused(params: fused.FusedStackedParams,
                               tokens: torch.Tensor, cached_len: int,
                               pool: PagedQuantKVPool,
                               page_table: torch.Tensor, config: ModelConfig
                               ) -> Tuple[torch.Tensor, PagedQuantKVPool]:
    """Prefill only the uncached (1, Sq) suffix on the fused path (a prefix
    hit). The suffix's int8 K/V are written first; then each layer gathers
    and dequantizes the whole logical context (shared prefix and suffix)
    through the page table and attends it with the plain masked attention,
    as the reference (XLA there, not a kernel). A hit therefore attends the
    int8-rounded K/V where a cold prefill attends f32 ones. Returns (logits
    (vocab,) of the prompt's last position, pool)."""
    resolve_device(tokens.device)
    lp = params.layers
    Sq = tokens.shape[1]
    P = pool.page_size
    T = page_table.shape[0] * P
    KVH, D = config.num_kv_heads, config.head_dim
    dev = tokens.device
    positions = int(cached_len) + torch.arange(Sq, device=dev)
    x = params.embed[tokens[0]].float()
    cos, sin = llama.rope_tables(config, positions[None])
    valid = torch.arange(T, device=dev)[None, :] <= positions[:, None]
    mask = llama._mask(valid)[None, None, None]
    pages, offs = _token_pages(page_table, positions, P)
    table = page_table.long()

    def context(codes, scales):
        # (max_pages, KVH, P, D) -> (1, T, KVH, D), dequantized
        c = codes[table].float() * scales[table][..., None]
        return c.transpose(1, 2).reshape(1, T, KVH, D)

    for l in range(config.num_layers):
        q, k, v = fused._qkv(lp, l, x, cos, sin, config, (1, Sq))
        _write_pages(pool, l, pages, offs, k, v)
        attn = llama._attention(q, context(pool.k[l], pool.k_scale[l]),
                                context(pool.v[l], pool.v_scale[l]), mask)
        x = fused._mlp_and_o(lp, l, x, attn.reshape(Sq, config.q_dim),
                             config)
    return fused._last_logits(params, x, None, config), pool
