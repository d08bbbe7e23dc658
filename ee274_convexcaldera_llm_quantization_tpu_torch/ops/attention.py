"""Flash attention: decode over a head-major int8 KV cache, causal prefill.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.ops.attention``
for the serving path. The decode cache is ``(L, B, KVH, T, D)`` int8 with
``(L, B, KVH, T)`` f32 per-(token, head) scales.

- :func:`flash_decode_q8_staged`: the cache holds the tokens ``< pos[b]``;
  the current token's dequantized K/V arrive as ``k_new`` / ``v_new``.
- :func:`flash_decode_q8`: the inline path; the current token is already in
  the cache, and the tokens ``<= pos[b]`` are attended.
- :func:`flash_decode_q8_ab`: the all-batch kernel's function, staged or
  inline, on the block partition of :func:`_ab_blocks`.
- :func:`flash_decode_q8_paged`: the staged function over a paged pool
  ``(L, NP, KVH, P, D)`` int8 / ``(L, NP, KVH, P)`` f32 through
  ``(B, max_pages)`` page tables; block == page.
- :func:`flash_prefill`: causal GQA self-attention of a prompt, f32.

Each wrapper launches its hand-written CUDA kernel (``csrc/flash_decode.cu``,
``csrc/flash_prefill.cu``) for CUDA tensors, counts the launch, and runs
the plain PyTorch version defined beside it for CPU tensors only.
"""

from __future__ import annotations

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import _build

_NEG_INF = -1e30
_DOTS = ("i8", "f32")
# the CUDA decode kernel keeps a block's logits in shared memory
_MAX_CUDA_BLOCK_T = 256


def resolve_block_t(block_t: int, T: int) -> int:
    """``min(block_t, T)``, halved until it divides ``T`` (the reference's
    block resolution; in ``dots="i8"`` the block is part of the result)."""
    block_t = min(block_t, T)
    while T % block_t:
        block_t //= 2
    return block_t


def _ab_blocks(B: int, KVH: int, D: int, T: int, block_t: int,
               slab_budget: int = 2 << 20):
    """Pick (Bb, block_t) for the all-batch kernel: the largest row-slab
    whose int8 K block stays under ``slab_budget`` bytes. ``block_t`` is a
    multiple of 128 or the whole T. A copy of the reference's picker: in
    ``dots="i8"`` the block is part of the result, so the port walks the
    same blocks (``Bb`` only shapes the TPU's DMAs)."""
    block_t = min(block_t, T)
    if T <= 128 or T % 128:
        bt = T                       # single block: full-dim blocks pass
    else:
        bt = max(128, block_t - block_t % 128)
        while T % bt:
            bt -= 128
        while bt > 128 and B * KVH * bt * D > slab_budget:
            nbt = bt - 128
            while T % nbt:
                nbt -= 128
            if nbt < 128:
                break
            bt = nbt
    Bb = B
    while Bb > 1 and Bb * KVH * bt * D > slab_budget:
        Bb = max(d for d in range(1, Bb) if B % d == 0)
    return Bb, bt


def _check_dots(dots: str) -> None:
    if dots == "bf16":
        raise NotImplementedError(
            "dots='bf16' is not ported yet (ROADMAP.md, Queue B item 2)")
    if dots not in _DOTS:
        raise ValueError(f"unknown dots {dots!r}")


def _current_layer(t: torch.Tensor, layer: int) -> torch.Tensor:
    """``k_new``/``v_new`` as (B, KVH, D): the current layer's slice when
    they come layer-stacked (L, B, KVH, D)."""
    return t[layer] if t.dim() == 4 else t


def _scale_f32(D: int) -> float:
    """The softmax scale ``1 / sqrt(D)`` as the f32 the kernels multiply by."""
    return float(np.float32(1.0 / (D ** 0.5)))


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the decode kernels
# ---------------------------------------------------------------------------

def _decode_blocks_plain(q, k, v, ks, vs, layer: int, pos, bt: int,
                         dots: str, staged: bool):
    """Online softmax over the cache blocks of ``layer``, block by block as
    the kernel walks them (same updates, same i8 quantization blocks).
    Attends the tokens ``< pos`` (staged) or ``<= pos`` (inline). Returns
    the running (max, sum, accumulator), (B, KVH, G, 1 | D) f32."""
    _check_dots(dots)
    B, KVH, G, D = q.shape
    T = k.shape[3]
    scale = 1.0 / (D ** 0.5)
    kl, vl = k[layer], v[layer]                       # (B, KVH, T, D)
    ksl, vsl = ks[layer].float(), vs[layer].float()   # (B, KVH, T)
    qf = q.float()
    dev = q.device
    pos = pos.to(device=dev, dtype=torch.int64)
    n = torch.clamp(pos if staged else pos + 1, max=T)  # tokens attended
    m = torch.full((B, KVH, G, 1), _NEG_INF, dtype=torch.float32, device=dev)
    s = torch.zeros((B, KVH, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, D), dtype=torch.float32, device=dev)
    if dots == "i8":
        qs = qf.abs().amax(dim=3, keepdim=True).clamp_min(1e-12) * (
            1.0 / 127.0)
        qi = torch.round(qf / qs)
    last = torch.clamp(n - 1, min=0) // bt
    for t in range(T // bt):
        sl = slice(t * bt, (t + 1) * bt)
        kb, vb = kl[:, :, sl], vl[:, :, sl]           # (B, KVH, bt, D)
        if dots == "i8":
            logits = (qi.double() @ kb.double().transpose(-1, -2)).float() * qs
        else:
            logits = qf @ kb.float().transpose(-1, -2)
        logits = logits * (ksl[:, :, sl] * scale)[:, :, None, :]
        tok = t * bt + torch.arange(bt, device=dev)
        valid = tok[None, None, None, :] < n[:, None, None, None]
        logits = torch.where(valid, logits, torch.full_like(logits, _NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=3, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(logits - m_new),
                        torch.zeros_like(logits))
        s_new = s * alpha + p.sum(dim=3, keepdim=True)
        pv = p * vsl[:, :, sl][:, :, None, :]         # (B, KVH, G, bt)
        if dots == "i8":
            pvs = pv.amax(dim=3, keepdim=True).clamp_min(1e-30) * (1.0 / 127.0)
            pvi = torch.round(pv / pvs)
            contrib = (pvi.double() @ vb.double()).float() * pvs
        else:
            contrib = pv @ vb.float()
        acc_new = acc * alpha + contrib
        live = ((t <= last) & (n > 0))[:, None, None, None]
        m = torch.where(live, m_new, m)
        s = torch.where(live, s_new, s)
        acc = torch.where(live, acc_new, acc)
    return m, s, acc


def _add_current_token(q, m, s, acc, k_new, v_new, layer: int):
    """The staged kernels' last update: the current token's f32 K/V, then
    the normalization."""
    D = q.shape[3]
    qf = q.float()
    kn = _current_layer(k_new, layer).float()
    vn = _current_layer(v_new, layer).float()
    logit = (qf * kn[:, :, None, :]).sum(dim=3, keepdim=True) * (
        1.0 / (D ** 0.5))
    m_new = torch.maximum(m, logit)
    alpha = torch.exp(m - m_new)
    p = torch.exp(logit - m_new)
    s = s * alpha + p
    acc = acc * alpha + p * vn[:, :, None, :]
    return acc / s


def flash_decode_q8_staged_plain(q, k, v, ks, vs, k_new, v_new, layer: int,
                                 pos, block_t: int = 256,
                                 dots: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode_q8_staged`."""
    bt = resolve_block_t(block_t, k.shape[3])
    m, s, acc = _decode_blocks_plain(q, k, v, ks, vs, layer, pos, bt, dots,
                                     staged=True)
    return _add_current_token(q, m, s, acc, k_new, v_new, layer)


def flash_decode_q8_plain(q, k, v, ks, vs, layer: int, pos,
                          block_t: int = 256,
                          dots: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode_q8`."""
    bt = resolve_block_t(block_t, k.shape[3])
    _, s, acc = _decode_blocks_plain(q, k, v, ks, vs, layer, pos, bt, dots,
                                     staged=False)
    return acc / s


def flash_decode_q8_ab_plain(q, k, v, ks, vs, k_new, v_new, layer: int, pos,
                             staged: bool = False, block_t: int = 64,
                             dots: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode_q8_ab`: the row
    kernels' function on :func:`_ab_blocks`' block partition."""
    B, KVH, _, D = q.shape
    _, bt = _ab_blocks(B, KVH, D, k.shape[3], block_t)
    m, s, acc = _decode_blocks_plain(q, k, v, ks, vs, layer, pos, bt, dots,
                                     staged)
    if staged:
        return _add_current_token(q, m, s, acc, k_new, v_new, layer)
    return acc / s


# ---------------------------------------------------------------------------
# Decode kernel wrappers (CUDA: csrc/flash_decode.cu)
# ---------------------------------------------------------------------------

def _launch_decode(entry: str, q, k, v, ks, vs, k_new, v_new, layer: int,
                   pos, bt: int, dots: str, *flags: int,
                   page_tables=None) -> torch.Tensor:
    """Check the operands and launch one entry of ``csrc/flash_decode.cu``
    on layer ``layer`` of the cache or pool (a pointer offset, never a
    copy). ``page_tables`` (B, max_pages) selects the paged entry, whose
    blocks are the pool's pages (``bt`` = page size); the caller has checked
    the page ids (:func:`_check_pages`)."""
    B, KVH, G, D = q.shape
    T = k.shape[3]
    if G > 8 or D > 128 or D % 16 or bt > _MAX_CUDA_BLOCK_T:
        raise ValueError(
            f"the CUDA decode kernel takes G <= 8, D <= 128 with D % 16 == 0 "
            f"and blocks (pages) of at most {_MAX_CUDA_BLOCK_T} tokens; got "
            f"G={G} D={D} block_t={bt} (T={T}; the all-batch partition is "
            "one block of the whole T when T <= 128 or T % 128 != 0)")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError("the KV cache must be int8")
    qf = q.float().contiguous()
    ksf, vsf = ks.float(), vs.float()
    pos32 = pos.to(torch.int32).contiguous()
    news, tables = [], []
    if k_new is not None:
        news = [_current_layer(t, layer).float().contiguous()
                for t in (k_new, v_new)]
    if page_tables is not None:
        tables = [page_tables.to(torch.int32).contiguous()]
    # the kernel reads through raw pointers: every shape must agree first
    streams = (B if page_tables is None else k.shape[1], KVH)
    if (k.dim() != 5 or tuple(k.shape[1:3]) != streams or k.shape[4] != D
            or v.shape != k.shape or ks.shape != k.shape[:4]
            or vs.shape != k.shape[:4] or tuple(pos32.shape) != (B,)
            or any(tuple(t.shape) != (B, KVH, D) for t in news)
            or any(t.shape[0] != B for t in tables)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k/v {tuple(k.shape)}, "
            f"scales {tuple(ks.shape)}, pos {tuple(pos.shape)}, current "
            f"K/V {[tuple(t.shape) for t in news]}, page tables "
            f"{[tuple(t.shape) for t in tables]}")
    for t in (qf, k, v, ksf, vsf, pos32, *news, *tables):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("attention operands must be contiguous and on "
                             "one device")
    layer_kv = k[0].numel()
    layer_s = ksf[0].numel() * 4
    out = torch.empty((B, KVH, G, D), dtype=torch.float32, device=q.device)
    ptrs = [qf.data_ptr(), k.data_ptr() + layer * layer_kv,
            v.data_ptr() + layer * layer_kv, ksf.data_ptr() + layer * layer_s,
            vsf.data_ptr() + layer * layer_s]
    ptrs += [t.data_ptr() for t in news] or [None, None]
    if entry == "flash_decode_inline_launch":
        ptrs = ptrs[:5]
    ptrs.append(pos32.data_ptr())
    if tables:
        ptrs.append(tables[0].data_ptr())
        T = tables[0].shape[1]              # the entry takes max_pages
    fn = getattr(_build.library("flash_decode"), entry)
    err = fn(*ptrs, out.data_ptr(), B, KVH, G, D, T, bt, _scale_f32(D),
             int(dots == "i8"), *flags, _build.stream_ptr(q.device))
    _build.check(err, entry)
    return out


def _check_layer(k, layer: int) -> None:
    Lk = k.shape[0]
    if not 0 <= layer < Lk:
        raise IndexError(f"layer {layer} out of range for {Lk} layers")


def flash_decode_q8_staged(q, k, v, ks, vs, k_new, v_new, layer: int, pos,
                           block_t: int = 256,
                           dots: str = "f32") -> torch.Tensor:
    """Single-token attention against layer ``layer`` of a stacked
    head-major int8 KV cache, plus the staged current token.

    Args: ``q`` (B, KVH, G, D) f32; ``k``/``v`` (L, B, KVH, T, D) int8;
    ``ks``/``vs`` (L, B, KVH, T) f32; ``k_new``/``v_new`` this step's
    dequantized K/V, (B, KVH, D) or layer-stacked (L, B, KVH, D); ``pos``
    (B,) int32, the cache holding tokens ``< pos[b]``; ``dots`` "i8" (int8
    q and p * v_scale, exact integer dots) or "f32". Returns
    (B, KVH, G, D) f32.
    """
    _check_dots(dots)
    _check_layer(k, layer)
    if q.device.type == "cpu":
        return flash_decode_q8_staged_plain(q, k, v, ks, vs, k_new, v_new,
                                            layer, pos, block_t, dots)
    out = _launch_decode("flash_decode_staged_launch", q, k, v, ks, vs,
                         k_new, v_new, layer, pos,
                         resolve_block_t(block_t, k.shape[3]), dots)
    flash_decode_q8_staged.launches += 1
    return out


flash_decode_q8_staged.launches = 0


def flash_decode_q8(q, k, v, ks, vs, layer: int, pos, block_t: int = 256,
                    dots: str = "f32") -> torch.Tensor:
    """Single-token attention against layer ``layer`` of a stacked
    head-major int8 KV cache that already holds the current token: the
    tokens ``<= pos[b]`` are attended (the inline decode path).

    Args as :func:`flash_decode_q8_staged`, without ``k_new``/``v_new``.
    Returns (B, KVH, G, D) f32.
    """
    _check_dots(dots)
    _check_layer(k, layer)
    if q.device.type == "cpu":
        return flash_decode_q8_plain(q, k, v, ks, vs, layer, pos, block_t,
                                     dots)
    out = _launch_decode("flash_decode_inline_launch", q, k, v, ks, vs,
                         None, None, layer, pos,
                         resolve_block_t(block_t, k.shape[3]), dots)
    flash_decode_q8.launches += 1
    return out


flash_decode_q8.launches = 0


def flash_decode_q8_ab(q, k, v, ks, vs, k_new, v_new, layer: int, pos,
                       staged: bool = False, block_t: int = 64,
                       dots: str = "f32") -> torch.Tensor:
    """The all-batch decode attention: :func:`flash_decode_q8_staged`
    (``staged``) or :func:`flash_decode_q8` (inline) on the block partition
    :func:`_ab_blocks` picks from the cap ``block_t``. ``k_new``/``v_new``
    are read only when ``staged`` (None is accepted otherwise). Returns
    (B, KVH, G, D) f32.
    """
    _check_dots(dots)
    _check_layer(k, layer)
    if staged and (k_new is None or v_new is None):
        raise ValueError("staged=True needs k_new and v_new")
    if q.device.type == "cpu":
        return flash_decode_q8_ab_plain(q, k, v, ks, vs, k_new, v_new, layer,
                                        pos, staged, block_t, dots)
    B, KVH, _, D = q.shape
    _, bt = _ab_blocks(B, KVH, D, k.shape[3], block_t)
    out = _launch_decode("flash_decode_ab_launch", q, k, v, ks, vs,
                         k_new if staged else None,
                         v_new if staged else None, layer, pos, bt, dots,
                         int(staged))
    flash_decode_q8_ab.launches += 1
    return out


flash_decode_q8_ab.launches = 0


# ---------------------------------------------------------------------------
# Paged decode (CUDA: csrc/flash_decode.cu, flash_decode_paged_launch)
# ---------------------------------------------------------------------------

def _check_pages(page_tables, num_pages: int) -> None:
    """Every page id in range: on the card an id out of range is an illegal
    address, not a wrong answer (and torch would wrap a negative one)."""
    if page_tables.dim() != 2 or page_tables.dtype.is_floating_point:
        raise ValueError("page_tables must be an integer (B, max_pages) "
                         f"tensor, got {page_tables.dtype} "
                         f"{tuple(page_tables.shape)}")
    lo, hi = (int(x) for x in torch.aminmax(page_tables))
    if lo < 0 or hi >= num_pages:
        raise IndexError(f"page ids [{lo}, {hi}] out of range for a pool of "
                         f"{num_pages} pages")


def _gather_pages(pool, layer: int, page_tables) -> torch.Tensor:
    """Layer ``layer`` of a paged pool ``(L, NP, KVH, P[, D])`` gathered
    through ``(B, max_pages)`` tables into a contiguous one-layer cache
    ``(1, B, KVH, max_pages * P[, D])``: logical token ``j`` of row ``b`` is
    page ``page_tables[b, j // P]``, offset ``j % P``."""
    g = pool[layer][page_tables.long()].transpose(1, 2)
    B, KVH, n, P = g.shape[:4]
    return g.reshape(B, KVH, n * P, *g.shape[4:])[None]


def flash_decode_q8_paged_plain(q, k, v, ks, vs, k_new, v_new, layer: int,
                                page_tables, pos,
                                dots: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode_q8_paged`: each row's
    pages gathered through its table into a contiguous cache ``(1, B, KVH,
    max_pages * P, D)``, then the staged kernel's walk with one block per
    page (in ``dots="i8"`` the blocks are part of the result) and the
    current token."""
    P = k.shape[3]
    kg, vg, ksg, vsg = (_gather_pages(t, layer, page_tables)
                        for t in (k, v, ks, vs))
    m, s, acc = _decode_blocks_plain(q, kg, vg, ksg, vsg, 0, pos, P, dots,
                                     staged=True)
    return _add_current_token(q, m, s, acc, k_new, v_new, layer)


def flash_decode_q8_paged(q, k, v, ks, vs, k_new, v_new, layer: int,
                          page_tables, pos, dots: str = "f32"
                          ) -> torch.Tensor:
    """Single-token attention over layer ``layer`` of a paged head-major
    int8 KV pool, plus the staged current token.

    Args: ``q`` (B, KVH, G, D) f32; ``k``/``v`` (L, NP, KVH, P, D) int8;
    ``ks``/``vs`` (L, NP, KVH, P) f32; ``k_new``/``v_new`` this step's
    dequantized K/V, (B, KVH, D) or layer-stacked (L, B, KVH, D);
    ``page_tables`` (B, max_pages) int, every id ``< NP``; ``pos`` (B,)
    int32, the pool holding row ``b``'s tokens ``< pos[b]`` (logical token
    ``j`` at page ``page_tables[b, j // P]``, offset ``j % P``); ``dots``
    "i8" or "f32". Block == page, so pages hold at most 256 tokens on the
    card. Returns (B, KVH, G, D) f32.
    """
    _check_dots(dots)
    _check_layer(k, layer)
    _check_pages(page_tables, k.shape[1])
    if q.device.type == "cpu":
        return flash_decode_q8_paged_plain(q, k, v, ks, vs, k_new, v_new,
                                           layer, page_tables, pos, dots)
    out = _launch_decode("flash_decode_paged_launch", q, k, v, ks, vs, k_new,
                         v_new, layer, pos, k.shape[3], dots,
                         page_tables=page_tables)
    flash_decode_q8_paged.launches += 1
    return out


flash_decode_q8_paged.launches = 0


# ---------------------------------------------------------------------------
# Exact-softmax twins (the reference's *_xla functions), plain PyTorch
# ---------------------------------------------------------------------------

def _exact_logits(q, k, ks, layer: int, pos, inclusive: bool):
    B, KVH, G, D = q.shape
    kl, ksl = k[layer].float(), ks[layer].float()
    T = kl.shape[2]
    sqrt_d = torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    logits = torch.einsum("bhgd,bhtd->bhgt", q.float(), kl)
    logits = logits * (ksl[:, :, None, :] / sqrt_d)
    tok = torch.arange(T, device=q.device)[None, None, None, :]
    p = pos.to(q.device)[:, None, None, None]
    valid = tok <= p if inclusive else tok < p
    return torch.where(valid, logits, torch.full_like(logits, _NEG_INF))


def flash_decode_q8_xla(q, k, v, ks, vs, layer: int, pos) -> torch.Tensor:
    """Exact-softmax twin of :func:`flash_decode_q8` with f32 dots (the
    reference's ``flash_decode_q8_xla``): cache tokens ``<= pos``."""
    probs = torch.softmax(_exact_logits(q, k, ks, layer, pos, True), dim=-1)
    pv = probs * vs[layer].float()[:, :, None, :]
    return torch.einsum("bhgt,bhtd->bhgd", pv, v[layer].float())


def flash_decode_q8_staged_xla(q, k, v, ks, vs, k_new, v_new, layer: int,
                               pos) -> torch.Tensor:
    """Exact-softmax twin of :func:`flash_decode_q8_staged` with f32 dots
    (the reference's ``flash_decode_q8_staged_xla``): cache tokens
    ``< pos`` plus the staged current token, one softmax over all."""
    D = q.shape[3]
    T = k.shape[3]
    kn = _current_layer(k_new, layer).float()
    vn = _current_layer(v_new, layer).float()
    sqrt_d = torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    logits = _exact_logits(q, k, ks, layer, pos, False)
    cur = torch.einsum("bhgd,bhd->bhg", q.float(), kn) / sqrt_d
    logits = torch.cat([logits, cur[..., None]], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    pv = probs[..., :T] * vs[layer].float()[:, :, None, :]
    out = torch.einsum("bhgt,bhtd->bhgd", pv, v[layer].float())
    return out + probs[..., T:] * vn[:, :, None, :]


def flash_decode_q8_paged_xla(q, k, v, ks, vs, k_new, v_new, layer: int,
                              page_tables, pos) -> torch.Tensor:
    """Exact-softmax twin of :func:`flash_decode_q8_paged` with f32 dots
    (the reference's ``flash_decode_q8_paged_xla``): the rows' pages
    gathered, then :func:`flash_decode_q8_staged_xla`."""
    kg, vg, ksg, vsg = (_gather_pages(t, layer, page_tables)
                        for t in (k, v, ks, vs))
    return flash_decode_q8_staged_xla(q, kg, vg, ksg, vsg,
                                      _current_layer(k_new, layer),
                                      _current_layer(v_new, layer), 0, pos)


# ---------------------------------------------------------------------------
# Causal flash prefill (CUDA: csrc/flash_prefill.cu)
# ---------------------------------------------------------------------------

def flash_prefill_plain(q, k, v, block_k: int = 64) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_prefill`: the same online
    softmax over ``block_k``-token key blocks, f32."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = _scale_f32(D)
    dev = q.device
    qh = q.float().reshape(B, S, KVH, G, D).permute(0, 2, 3, 1, 4)
    kh = k.float().permute(0, 2, 1, 3)[:, :, None]    # (B, KVH, 1, S, D)
    vh = v.float().permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((B, KVH, G, S, 1), _NEG_INF, dtype=torch.float32,
                   device=dev)
    s = torch.zeros((B, KVH, G, S, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, S, D), dtype=torch.float32, device=dev)
    tq = torch.arange(S, device=dev)[:, None]
    for k0 in range(0, S, block_k):
        kb, vb = kh[..., k0:k0 + block_k, :], vh[..., k0:k0 + block_k, :]
        logits = (qh @ kb.transpose(-1, -2)) * scale  # (B, KVH, G, S, bk)
        valid = k0 + torch.arange(kb.shape[-2], device=dev)[None, :] <= tq
        logits = torch.where(valid, logits, torch.full_like(logits, _NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(logits - m_new),
                        torch.zeros_like(logits))
        s = s * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vb
        m = m_new
    out = (acc / s).permute(0, 3, 1, 2, 4)            # (B, S, KVH, G, D)
    return out.reshape(B, S, H, D)


def flash_prefill(q, k, v) -> torch.Tensor:
    """Causal flash self-attention for prefill.

    ``q`` (B, S, H, D), GQA head-major ``h = kvh * G + g``; ``k``/``v``
    (B, S, KVH, D). Returns (B, S, H, D) f32. Any S: the kernel masks the
    ragged last blocks itself (the reference pads S to its block sizes).
    """
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if H % KVH or k.shape != (B, S, KVH, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v)
    if D % 4 or D > 128 or H // KVH > 64:
        raise ValueError(f"the CUDA prefill kernel takes D <= 128 with "
                         f"D % 4 == 0 and at most 64 query heads per kv "
                         f"head; got D={D}, G={H // KVH}")
    qf, kf, vf = (t.float().contiguous() for t in (q, k, v))
    for t in (kf, vf):
        if t.device != q.device:
            raise ValueError("attention operands must be on one device")
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    err = _build.library("flash_prefill").flash_prefill_launch(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), B, S, H,
        KVH, D, _scale_f32(D), _build.stream_ptr(q.device))
    _build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
