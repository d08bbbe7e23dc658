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
- :func:`flash_decode_attn_o`: the staged or inline attention with f32 dots
  (MHA) fused with the W4A8 o_proj and its int8 factors.
- :func:`flash_prefill`: causal GQA self-attention of a prompt, f32.

Each wrapper launches its hand-written CUDA kernel (``csrc/flash_decode.cu``
for the staged and inline kernels, ``csrc/flash_decode_split.cu`` for the
all-batch and paged ones, ``csrc/attn_o.cu``, ``csrc/flash_prefill.cu``) for
CUDA tensors, counts the launch, and runs the plain PyTorch version defined
beside it for CPU tensors only.
"""

from __future__ import annotations

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import _build
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K

_NEG_INF = -1e30
# the decode kernels' dot modes, as the C entries number them
_DOTS = {"f32": 0, "bf16": 1, "i8": 2}


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
    Attends the tokens ``< pos`` (staged) or ``<= pos`` (inline). In
    ``dots="bf16"`` q and ``p * v_scale`` round to bf16 before their dots
    with the int8 codes (exact in bf16); the products are exact in f32, so
    the dots are f32 matmuls of the rounded values. Returns the running
    (max, sum, accumulator), (B, KVH, G, 1 | D) f32."""
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
    qd = qf.to(torch.bfloat16).float() if dots == "bf16" else qf
    last = torch.clamp(n - 1, min=0) // bt
    for t in range(T // bt):
        sl = slice(t * bt, (t + 1) * bt)
        kb, vb = kl[:, :, sl], vl[:, :, sl]           # (B, KVH, bt, D)
        if dots == "i8":
            logits = (qi.double() @ kb.double().transpose(-1, -2)).float() * qs
        else:
            logits = qd @ kb.float().transpose(-1, -2)
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
        elif dots == "bf16":
            contrib = pv.to(torch.bfloat16).float() @ vb.float()
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
# Decode kernel wrappers (CUDA: csrc/flash_decode.cu, csrc/flash_decode_split.cu)
# ---------------------------------------------------------------------------

def _decode_operands(kernel: str, q, k, v, ks, vs, k_new, v_new,
                     layer: int, pos, page_tables=None):
    """Check the operands of the decode kernel ``kernel`` (its source, for
    the messages) and return the pointers its C entry takes: q, layer
    ``layer`` of k, v, ks, vs (a pointer offset, never a copy), k_new and
    v_new (None when absent), pos and the page tables (None for a contiguous
    cache); and the operands kept alive meanwhile."""
    B, KVH, G, D = q.shape
    if G > 8 or D > 128 or D % 16:
        raise ValueError(
            f"{kernel} takes G <= 8, D <= 128 with D % 16 == 0; got G={G} "
            f"D={D}")
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
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the int8 K/V cache must start on a 16-byte "
                         "boundary (the kernels read it in 16-byte vectors)")
    layer_kv = k[0].numel()
    layer_s = ksf[0].numel() * 4
    ptrs = [qf.data_ptr(), k.data_ptr() + layer * layer_kv,
            v.data_ptr() + layer * layer_kv, ksf.data_ptr() + layer * layer_s,
            vsf.data_ptr() + layer * layer_s]
    ptrs += [t.data_ptr() for t in news] or [None, None]
    ptrs.append(pos32.data_ptr())
    ptrs.append(tables[0].data_ptr() if tables else None)
    return ptrs, (qf, ksf, vsf, pos32, *news, *tables)


# tokens of a window; (block, head) pairs of a window and of a CTA; CTAs of
# a stream (a cluster); ring slots; dynamic shared memory of a CTA (the row
# kernel's kWin, kWinPairs, kMaxPairs, kMaxCluster, kSlots, kMaxSmem)
_ROW_WIN = 256
_ROW_WIN_PAIRS = 16
_ROW_MAX_PAIRS = 128
_ROW_MAX_CLUSTER = 8
_ROW_SLOTS = 1
_ROW_MAX_SMEM = 232448
# CTAs a launch aims at per SM
_ROW_COVER = 2


def _row_smem(G: int, D: int, bt: int, maxb: int, nbw: int,
              cluster: int) -> int:
    """Dynamic shared memory of the row kernel's plan, in bytes: a mirror of
    ``row_layout`` in ``csrc/flash_decode.cu``, which owns the layout (each
    part on 128 bytes; the slots also stage a cluster's blocks for the
    chain). The launch refuses a plan whose bytes differ from the kernel's
    own count."""
    def part(n):
        return -(-n // 128) * 128
    span = maxb * bt
    stage = cluster * maxb * G * (16 + 4 * D) if cluster > 1 else 0
    return (part(max(_ROW_SLOTS * part(nbw * bt * D), stage))
            + 2 * part(4 * span)
            + part(4 * G * span) + part(G * span) + part(16 * nbw * G * D)
            + part(4 * maxb * G * D) + part(16 * maxb * G)
            + part(4 * maxb * G) + part(32) + part(4 * G * D) + part(G * D)
            + 2 * part(32) + part(4 * (G + 2) * D))


def _row_decode_plan(B: int, KVH: int, G: int, D: int, T: int, bt: int,
                     sms: int) -> dict:
    """The launch of ``csrc/flash_decode.cu`` for B rows of KVH streams, G
    query heads of D columns, a T-token cache in blocks of ``bt`` tokens, on
    ``sms`` SMs. Shapes only: the kernel finds each row's live blocks from
    ``pos`` on the device, so the launch can be captured in a CUDA graph.

    - ``route`` "row": the row kernel. Each stream's blocks go to a
      thread-block ``cluster`` of 1-8 CTAs (enough CTAs to cover
      ``_ROW_COVER`` x ``sms``, at most one a block), each CTA a contiguous
      range of at most ``maxb`` = ceil(T / bt / cluster) blocks; the CTA
      copies its blocks in windows of ``nbw`` whole blocks (at most 256
      tokens and 16 (block, head) pairs), K windows then V windows, through
      its ring's window slot; ``smem`` bytes of dynamic shared memory;
      ``grid`` CTAs.
    - ``route`` "walk": a block over 256 tokens: the sequential walk of
      ``csrc/flash_decode.cuh`` in sub-tile passes, one CTA a stream
      (``grid`` B * KVH).
    - ``route`` "split": a cache of shorter blocks too long for eight CTAs'
      shared memory (at B 8 on 132 SMs: over 57344 tokens for Llama-2-7B's
      heads, 16384 for Llama-3-8B's, 14336 for Qwen2-0.5B's): the wrappers
      launch the block-parallel kernel of ``csrc/flash_decode_split.cu``
      instead, whose outputs are the same bits."""
    if bt < 1 or T < bt or T % bt or min(B, KVH, G, D, sms) < 1:
        raise ValueError(f"no plan for T={T} in blocks of {bt}")
    streams = B * KVH
    if bt > _ROW_WIN:
        return dict(route="walk", cluster=0, nbw=0, maxb=0, smem=0,
                    grid=streams)
    nblk = T // bt
    nbw = max(1, min(_ROW_WIN // bt, _ROW_WIN_PAIRS // G))
    # enough CTAs to cover the SMs, then as few as take that many blocks
    # each (no CTA of the cluster idle on the longest row)
    want = max(1, min(_ROW_MAX_CLUSTER, nblk,
                      -(-_ROW_COVER * sms // streams)))
    want = -(-nblk // -(-nblk // want))
    for C in range(want, _ROW_MAX_CLUSTER + 1):
        maxb = -(-nblk // C)
        smem = _row_smem(G, D, bt, maxb, nbw, C)
        if maxb * G <= _ROW_MAX_PAIRS and smem <= _ROW_MAX_SMEM:
            return dict(route="row", cluster=C, nbw=nbw, maxb=maxb,
                        smem=smem, grid=streams * C)
    return dict(route="split", cluster=0, nbw=0, maxb=0, smem=0, grid=0)


def _row_ranges(plan: dict, nb: int) -> list:
    """The blocks [lo, hi) each CTA of a stream with ``nb`` live blocks
    takes under ``plan`` (a mirror of ``row_kernel``): ceil(nb / cluster)
    a CTA, contiguous, in rank order."""
    C = plan["cluster"]
    per = -(-nb // C)
    return [(min(r * per, nb), min(min(r * per, nb) + per, nb))
            for r in range(C)]


def _launch_decode(entry: str, q, k, v, ks, vs, k_new, v_new, layer: int,
                   pos, bt: int, dots: str) -> torch.Tensor:
    """Check the operands and launch ``flash_decode_staged_launch`` or
    ``flash_decode_inline_launch`` of ``csrc/flash_decode.cu`` on layer
    ``layer`` of the cache, in blocks of ``bt`` tokens, on the plan of
    :func:`_row_decode_plan`; on a plan of route "split", the block-parallel
    kernel (:func:`_launch_split`) on the same block."""
    B, KVH, G, D = q.shape
    T = k.shape[3]
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = _row_decode_plan(B, KVH, G, D, T, bt, K._sm_count(index))
    staged = entry == "flash_decode_staged_launch"
    if plan["route"] == "split":
        return _launch_split(q, k, v, ks, vs, k_new, v_new, layer, pos, bt,
                             dots, staged)
    ptrs, _keep = _decode_operands("csrc/flash_decode.cu", q, k, v, ks, vs,
                                   k_new, v_new, layer, pos)
    ptrs.pop()                              # no page tables
    if not staged:
        ptrs = ptrs[:5] + ptrs[7:]          # no current token
    out = torch.empty((B, KVH, G, D), dtype=torch.float32, device=q.device)
    fn = getattr(_build.library("flash_decode"), entry)
    err = fn(*ptrs, out.data_ptr(), B, KVH, G, D, T, bt, _scale_f32(D),
             _DOTS[dots], *(plan[n] for n in ("cluster", "nbw", "maxb",
                                              "smem")),
             _build.stream_ptr(q.device))
    _build.check(err, entry)
    return out


# tokens of a chunk and of a window; (block, head) pairs of a window;
# segment maxima of a window; bytes of a whole stream's K rows; CTAs an SM
# holds (the kernel's kChunk, kSlots, kMaxSegs, kWholeBytes and
# __launch_bounds__)
_SPLIT_CHUNK = 256
_SPLIT_SLOTS = 12
_SPLIT_SEGS = 1024
_SPLIT_WHOLE_BYTES = 24576
_SPLIT_RESIDENT = 3


def _decode_split_plan(B: int, KVH: int, G: int, D: int, T: int, bt: int,
                       sms: int) -> dict:
    """The work split of ``csrc/flash_decode_split.cu`` for B rows of KVH
    streams, G query heads of D columns, T cache tokens a row (max_pages *
    page size, paged) in blocks of ``bt`` tokens, on ``sms`` SMs. Shapes
    only: the kernel finds the live items from ``pos`` on the device.

    - Segments (``seg`` = min(bt, 256) tokens, ``spb`` a block, ``nseg`` a
      stream) carry the maxima; a chunk (an A item) is ``asegs`` segments:
      whole blocks of at most 256 tokens, or a 256-token piece of a longer
      block.
    - A window (a B item) is ``nbw`` whole blocks of at most 256 tokens and
      ``_SPLIT_SLOTS`` (block, head) pairs, or one longer block.
    - A row attending no cache token, or whose live tokens fit one chunk,
      one window and ``_SPLIT_WHOLE_BYTES`` of K, takes one W item a stream
      instead; the others one C item a stream.
    - ``items``: the most items any positions give; ``grid``: persistent
      CTAs taking them in ticket order.
    - ``counters``: int32 words the kernel finds zero and leaves zero (the
      ticket, A and B items done a stream, CTAs out), from
      ``kernels._split_counters``.
    - Scratch, in 4-byte words: ``state`` (m, alpha, sum, code scale per
      block and head), ``logits``, ``smax`` (segment maxima) and
      ``contrib`` (a block's p @ V per head)."""
    if bt < 1 or T < bt or T % bt or min(B, KVH, G, D, sms) < 1:
        raise ValueError(f"no split of T={T} in blocks of {bt}")
    nblk = T // bt
    seg = min(bt, _SPLIT_CHUNK)
    spb = -(-bt // seg)
    if spb * G > _SPLIT_SEGS:
        raise ValueError(f"a block of {bt} tokens and {G} heads has more "
                         f"than {_SPLIT_SEGS} segment maxima")
    nseg = nblk * spb
    short = bt <= _SPLIT_CHUNK
    asegs = _SPLIT_CHUNK // bt if short else 1
    nbw = max(1, min(_SPLIT_CHUNK // bt, _SPLIT_SLOTS // G)) if short else 1
    streams = B * KVH
    items = streams * (-(-nseg // asegs) + -(-nblk // nbw) + 1)
    return dict(
        nblk=nblk, seg=seg, spb=spb, nseg=nseg, asegs=asegs, nbw=nbw,
        whole_tokens=_SPLIT_WHOLE_BYTES // D, items=items,
        grid=min(items, sms * _SPLIT_RESIDENT),
        counters=2 + 2 * streams, state=4 * streams * nblk * G,
        logits=streams * G * T, smax=streams * G * nseg,
        contrib=streams * nblk * G * D)


def _launch_split(q, k, v, ks, vs, k_new, v_new, layer: int, pos, bt: int,
                  dots: str, staged: bool, page_tables=None) -> torch.Tensor:
    """Check the operands and launch ``flash_decode_split_launch`` of
    ``csrc/flash_decode_split.cu`` on layer ``layer`` of the cache (blocks
    of ``bt`` tokens) or, with ``page_tables`` (B, max_pages), of the pool
    (blocks are its pages, ``bt`` the page size; the caller has checked the
    page ids, :func:`_check_pages`). The scratch comes from ``torch.empty``,
    the counters from ``kernels._split_counters`` (one zeroed buffer per
    stream and CUDA-graph capture, which the kernel leaves zeroed); nothing
    is read back to the host."""
    B, KVH, G, D = q.shape
    ptrs, _keep = _decode_operands("csrc/flash_decode_split.cu", q, k, v,
                                   ks, vs, k_new if staged else None,
                                   v_new if staged else None, layer, pos,
                                   page_tables)
    max_pages = 0 if page_tables is None else page_tables.shape[1]
    T = k.shape[3] if page_tables is None else max_pages * bt
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    plan = _decode_split_plan(B, KVH, G, D, T, bt, K._sm_count(index))
    # each part on a 16-byte boundary: the kernel copies 16 bytes at a time
    names = ("state", "logits", "smax", "contrib")
    sizes = [-(-plan[n] // 4) * 4 for n in names]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=q.device)
    offs = dict(zip(names, np.cumsum([0] + sizes[:-1]) * 4))
    counters = K._split_counters(q.device, plan["counters"])
    out = torch.empty((B, KVH, G, D), dtype=torch.float32, device=q.device)
    err = _build.library("flash_decode_split").flash_decode_split_launch(
        *ptrs, out.data_ptr(),
        *(scratch.data_ptr() + int(offs[n]) for n in
          ("logits", "smax", "state", "contrib")), counters.data_ptr(),
        B, KVH, G, D, T, bt, max_pages,
        *(plan[n] for n in ("seg", "spb", "nseg", "asegs", "nbw", "grid")),
        _scale_f32(D), _DOTS[dots], int(staged), _build.stream_ptr(q.device))
    _build.check(err, "flash_decode_split")
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
    q and p * v_scale, exact integer dots), "bf16" (both rounded to bf16,
    f32 sums) or "f32"; the current token's dot is f32 in every mode. Any
    ``block_t``: the CUDA kernel walks a block over 256 tokens in passes
    (``csrc/flash_decode.cuh``); a cache of shorter blocks longer than its
    shared memory takes runs the block-parallel kernel of
    ``csrc/flash_decode_split.cu`` (the same bits). Returns (B, KVH, G, D)
    f32.
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
    (B, KVH, G, D) f32. CUDA tensors go through the block-parallel kernel
    of ``csrc/flash_decode_split.cu``, whose outputs equal the row kernels'
    walk over the same blocks bit for bit.
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
    out = _launch_split(q, k, v, ks, vs, k_new, v_new, layer, pos, bt, dots,
                        staged)
    flash_decode_q8_ab.launches += 1
    return out


flash_decode_q8_ab.launches = 0


# ---------------------------------------------------------------------------
# Paged decode (CUDA: csrc/flash_decode_split.cu)
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
    "i8", "bf16" or "f32". Block == page, of any size. Returns
    (B, KVH, G, D) f32. The page ids are checked first (a read-back to the
    host); a caller that attends many layers through one table checks it
    once and calls :func:`_flash_decode_q8_paged` per layer.
    """
    _check_dots(dots)
    _check_layer(k, layer)
    _check_pages(page_tables, k.shape[1])
    return _flash_decode_q8_paged(q, k, v, ks, vs, k_new, v_new, layer,
                                  page_tables, pos, dots)


def _flash_decode_q8_paged(q, k, v, ks, vs, k_new, v_new, layer: int,
                           page_tables, pos, dots: str = "f32"
                           ) -> torch.Tensor:
    """:func:`flash_decode_q8_paged` on page tables whose ids the caller has
    checked (:func:`_check_pages`): CUDA tensors go through the
    block-parallel kernel of ``csrc/flash_decode_split.cu`` (no host
    read-back, so it can be captured in a CUDA graph); CPU tensors through
    :func:`flash_decode_q8_paged_plain`."""
    _check_dots(dots)
    _check_layer(k, layer)
    if q.device.type == "cpu":
        return flash_decode_q8_paged_plain(q, k, v, ks, vs, k_new, v_new,
                                           layer, page_tables, pos, dots)
    out = _launch_split(q, k, v, ks, vs, k_new, v_new, layer, pos,
                        k.shape[3], dots, True, page_tables=page_tables)
    flash_decode_q8_paged.launches += 1
    return out


flash_decode_q8_paged.launches = 0


# ---------------------------------------------------------------------------
# Fused attention + o_proj (CUDA: csrc/attn_o.cu)
# ---------------------------------------------------------------------------

def attn_o_supported(KVH: int, G: int, D: int, h: int, rank: int) -> bool:
    """Whether the fused attention + o_proj kernel takes this model (the
    reference's gate): MHA (G == 1), head_dim and rank on 128-lane
    boundaries, 128-divisible o_proj blocks of at most 256 rows."""
    bn = min(256, h)
    return (G == 1 and D % 128 == 0 and rank % 128 == 0
            and h % bn == 0 and bn >= 128)


def _check_attn_o(q, o_packed, o_R, num_bits: int, rank: int) -> None:
    B, KVH, G, D = q.shape
    if G != 1:
        raise ValueError("flash_decode_attn_o requires MHA (G == 1), got "
                         f"G={G}; use the unfused path for GQA models")
    qdim = KVH * D
    K._require(o_packed.shape[2] * K._pack_factor(num_bits) == qdim,
               f"o_packed {tuple(o_packed.shape)} against {qdim} inputs")
    K._require(o_packed.dtype == torch.uint8, f"o_packed is {o_packed.dtype}")
    K._require(tuple(o_R.shape[1:]) == (rank, qdim),
               f"o_R {tuple(o_R.shape)}")
    if B > 32:
        raise ValueError(f"batch {B} > 32 unsupported by the fused "
                         "attention+o kernel")


def flash_decode_attn_o_plain(q, k, v, ks, vs, k_new, v_new, layer: int,
                              pos, o_packed, o_scales, o_R, o_R_scale, o_L,
                              o_L_scale, num_bits: int, rank: int,
                              staged: bool = False,
                              block_t: int = 256) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode_attn_o`: the staged or
    inline decode attention's plain version with f32 dots into a flat
    (B, KVH * D) buffer, then ``xro = (bf16(attn) @ bf16(oR).T) * oRs`` and
    the o_proj through the l kernel's plain version (which quantizes
    ``attn`` per row)."""
    return _attn_o_plain_parts(q, k, v, ks, vs, k_new, v_new, layer, pos,
                               o_packed, o_scales, o_R, o_R_scale, o_L,
                               o_L_scale, num_bits, rank, staged,
                               block_t)["out"]


def _attn_o_plain_parts(q, k, v, ks, vs, k_new, v_new, layer: int, pos,
                        o_packed, o_scales, o_R, o_R_scale, o_L, o_L_scale,
                        num_bits: int, rank: int, staged: bool,
                        block_t: int):
    """:func:`flash_decode_attn_o_plain` with its intermediates: the flat
    attention ``attn``, its int8 codes ``xq8`` and the output ``out``."""
    _check_attn_o(q, o_packed, o_R, num_bits, rank)
    if staged:
        attn = flash_decode_q8_staged_plain(q, k, v, ks, vs, k_new, v_new,
                                            layer, pos, block_t, "f32")
    else:
        attn = flash_decode_q8_plain(q, k, v, ks, vs, layer, pos, block_t,
                                     "f32")
    x = attn.reshape(q.shape[0], -1)
    xq, sx = K.quantize_activations_int8(x)
    xro = K.thin_xr(x, o_R[layer], o_R_scale[layer])
    return dict(attn=x, xq8=xq, out=K._l_from_codes(
        xq, sx, o_packed, o_scales, layer, xro, o_L, o_L_scale, num_bits,
        rank, (o_packed.shape[1],)))


def flash_decode_attn_o(q, k, v, ks, vs, k_new, v_new, layer: int, pos,
                        o_packed, o_scales, o_R, o_R_scale, o_L, o_L_scale,
                        num_bits: int, rank: int, staged: bool = False,
                        block_t: int = 256) -> torch.Tensor:
    """Decode attention fused with the W4A8 o_proj against layer ``layer``.

    Attention args are :func:`flash_decode_q8_staged`'s (``k_new`` /
    ``v_new`` are read only when ``staged``; None is accepted otherwise),
    with f32 dots, MHA only (``q`` (B, KVH, 1, D), B <= 32); then o_proj's
    stacked packed codes (L, h, KVH * D / f) uint8, row scales (L, h, 1),
    and int8 factors ``o_R`` (L, rank, KVH * D), ``o_L`` (L, h, rank) with
    their (L, rank | h, 1) scales. Returns the o_proj output (B, h) before
    its global scale. CUDA tensors go through the cooperative kernel of
    ``csrc/attn_o.cu``; CPU tensors through
    :func:`flash_decode_attn_o_plain`.
    """
    _check_layer(k, layer)
    if staged and (k_new is None or v_new is None):
        raise ValueError("staged=True needs k_new and v_new")
    if q.device.type == "cpu":
        return flash_decode_attn_o_plain(q, k, v, ks, vs, k_new, v_new,
                                         layer, pos, o_packed, o_scales, o_R,
                                         o_R_scale, o_L, o_L_scale, num_bits,
                                         rank, staged, block_t)
    _check_attn_o(q, o_packed, o_R, num_bits, rank)
    out, _ = _launch_attn_o(q, k, v, ks, vs, k_new, v_new, layer, pos,
                            o_packed, o_scales, o_R, o_R_scale, o_L,
                            o_L_scale, num_bits, rank, staged,
                            resolve_block_t(block_t, k.shape[3]))
    flash_decode_attn_o.launches += 1
    return out


def _launch_attn_o(q, k, v, ks, vs, k_new, v_new, layer: int, pos, o_packed,
                   o_scales, o_R, o_R_scale, o_L, o_L_scale, num_bits: int,
                   rank: int, staged: bool, bt: int, ctas: int = 0):
    """Check the operands and launch ``attn_o_launch`` on layer ``layer``
    (blocks of ``bt`` tokens, ``ctas`` CTAs; 0: the cooperative grid);
    returns the output and the kernel's scratch (the flat attention
    ``attn`` and its int8 codes ``xq8`` among it)."""
    B, KVH, _, D = q.shape
    T = k.shape[3]
    Lk, h = o_packed.shape[:2]
    qdim = KVH * D
    f = K._pack_factor(num_bits)
    if (D != 128 or num_bits not in (2, 4, 8) or qdim % (16 * f)
            or rank % K._FKC or h % 32):
        raise ValueError(f"the CUDA kernel takes D 128, 2/4/8-bit codes, "
                         f"rank % 128 == 0 and h % 32 == 0; got D={D}, "
                         f"{num_bits}-bit, rank {rank}, h {h}")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError("the KV cache must be int8")
    if o_R.dtype != torch.int8 or o_L.dtype != torch.int8:
        raise TypeError("o_R and o_L must be int8 codes")
    qf = q.float().contiguous()
    ksf, vsf = ks.float(), vs.float()
    pos32 = pos.to(torch.int32).contiguous()
    news = []
    if staged:
        news = [_current_layer(t, layer).float().contiguous()
                for t in (k_new, v_new)]
    o_s, oRs, oLs = (t.float().contiguous()
                     for t in (o_scales, o_R_scale, o_L_scale))
    if (k.dim() != 5 or tuple(k.shape[1:3]) != (B, KVH) or k.shape[4] != D
            or v.shape != k.shape or ks.shape != k.shape[:4]
            or vs.shape != k.shape[:4] or tuple(pos32.shape) != (B,)
            or any(tuple(t.shape) != (B, KVH, D) for t in news)
            or o_s.shape != (Lk, h, 1) or o_R.shape != (Lk, rank, qdim)
            or oRs.shape != (Lk, rank, 1) or o_L.shape != (Lk, h, rank)
            or oLs.shape != (Lk, h, 1)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k/v {tuple(k.shape)}, "
            f"scales {tuple(ks.shape)}, pos {tuple(pos.shape)}, current K/V "
            f"{[tuple(t.shape) for t in news]}, o_proj {tuple(o_packed.shape)}"
            f", R {tuple(o_R.shape)}, L {tuple(o_L.shape)}")
    for t in (qf, k, v, ksf, vsf, pos32, *news, o_packed, o_s, o_R, oRs, o_L,
              oLs):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous and on one device")
    dev = q.device
    (st,) = _attn_o_plan(B, qdim, h, rank, num_bits)
    grid = K._fused_grid("attn_o_grid", dev, B, num_bits, int(staged))
    grid = min(ctas, grid) if ctas else grid
    scratch = dict(
        attn=torch.empty((B, qdim), dtype=torch.float32, device=dev),
        amax=torch.empty((B * KVH,), dtype=torch.float32, device=dev),
        xpart=torch.empty((B * KVH, rank), dtype=torch.float32, device=dev),
        xq8=torch.empty((B, qdim), dtype=torch.int8, device=dev),
        xro=torch.empty((B, rank), dtype=torch.float32, device=dev),
        pws=K._fused_pws(dev, grid * K._ATTN_O_WARPS, st["MT"]),
        cnt=K._split_counters(dev, st["groups"]))
    out = torch.empty((B, h), dtype=torch.float32, device=dev)
    layer_kv = k[0].numel()
    layer_s = ksf[0].numel() * 4
    ptrs = [qf.data_ptr(), k.data_ptr() + layer * layer_kv,
            v.data_ptr() + layer * layer_kv, ksf.data_ptr() + layer * layer_s,
            vsf.data_ptr() + layer * layer_s]
    ptrs += [t.data_ptr() for t in news] or [None, None]
    err = _build.library("attn_o").attn_o_launch(
        *ptrs, pos32.data_ptr(), o_packed.data_ptr(), o_s.data_ptr(),
        o_R.data_ptr(), oRs.data_ptr(), o_L.data_ptr(), oLs.data_ptr(),
        *(scratch[n].data_ptr() for n in ("attn", "amax", "xpart", "xq8",
                                          "xro", "pws", "cnt")),
        out.data_ptr(), B, KVH, D, T, bt, _scale_f32(D), int(staged), h,
        num_bits, layer, rank, grid, _build.stream_ptr(dev))
    _build.check(err, "attn_o")
    return out, scratch


def _attn_o_plan(B: int, qdim: int, h: int, rank: int, num_bits: int):
    """The fused attention + o_proj kernel's one projection stage (the
    o_proj, ``attn_o_launch``'s plan): groups of 32 rows, one tile of B
    activation rows."""
    return (K._fused_stage(qdim, h, rank, num_bits, B),)


flash_decode_attn_o.launches = 0


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
    # contiguous f32 at 16-byte aligned bases: the kernel reads them by TMA
    qf, kf, vf = (t.float().contiguous() for t in (q, k, v))
    qf, kf, vf = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (qf, kf, vf))
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
