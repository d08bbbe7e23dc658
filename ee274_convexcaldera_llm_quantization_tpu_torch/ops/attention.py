"""Staged flash-decode attention over a head-major int8 KV cache.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.ops.attention``
for the decode step's staged path. The cache is ``(L, B, KVH, T, D)`` int8
with ``(L, B, KVH, T)`` f32 per-(token, head) scales and holds the tokens
``< pos[b]``; the current token's dequantized K/V arrive as ``k_new`` /
``v_new``. :func:`flash_decode_q8_staged` launches ``csrc/
flash_decode_staged.cu`` for CUDA tensors and runs
:func:`flash_decode_q8_staged_plain` for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch.ops import _build

_NEG_INF = -1e30
_DOTS = ("i8", "f32")


def resolve_block_t(block_t: int, T: int) -> int:
    """``min(block_t, T)``, halved until it divides ``T`` (the reference's
    block resolution; in ``dots="i8"`` the block is part of the result)."""
    block_t = min(block_t, T)
    while T % block_t:
        block_t //= 2
    return block_t


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


def flash_decode_q8_staged_plain(q, k, v, ks, vs, k_new, v_new, layer: int,
                                 pos, block_t: int = 256,
                                 dots: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode_q8_staged`, block by
    block as the kernel walks them (same online-softmax updates, same i8
    quantization blocks)."""
    _check_dots(dots)
    B, KVH, G, D = q.shape
    T = k.shape[3]
    bt = resolve_block_t(block_t, T)
    scale = 1.0 / (D ** 0.5)
    kl, vl = k[layer], v[layer]                       # (B, KVH, T, D)
    ksl, vsl = ks[layer].float(), vs[layer].float()   # (B, KVH, T)
    qf = q.float()
    dev = q.device
    pos = pos.to(device=dev, dtype=torch.int64)
    m = torch.full((B, KVH, G, 1), _NEG_INF, dtype=torch.float32, device=dev)
    s = torch.zeros((B, KVH, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, D), dtype=torch.float32, device=dev)
    if dots == "i8":
        qs = qf.abs().amax(dim=3, keepdim=True).clamp_min(1e-12) * (
            1.0 / 127.0)
        qi = torch.round(qf / qs)
    last = torch.clamp(pos - 1, min=0) // bt
    for t in range(T // bt):
        sl = slice(t * bt, (t + 1) * bt)
        kb, vb = kl[:, :, sl], vl[:, :, sl]           # (B, KVH, bt, D)
        if dots == "i8":
            logits = (qi.double() @ kb.double().transpose(-1, -2)).float() * qs
        else:
            logits = qf @ kb.float().transpose(-1, -2)
        logits = logits * (ksl[:, :, sl] * scale)[:, :, None, :]
        tok = t * bt + torch.arange(bt, device=dev)
        valid = tok[None, None, None, :] < pos[:, None, None, None]
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
        live = ((t <= last) & (pos > 0))[:, None, None, None]
        m = torch.where(live, m_new, m)
        s = torch.where(live, s_new, s)
        acc = torch.where(live, acc_new, acc)
    kn = _current_layer(k_new, layer).float()
    vn = _current_layer(v_new, layer).float()
    logit = (qf * kn[:, :, None, :]).sum(dim=3, keepdim=True) * scale
    m_new = torch.maximum(m, logit)
    alpha = torch.exp(m - m_new)
    p = torch.exp(logit - m_new)
    s = s * alpha + p
    acc = acc * alpha + p * vn[:, :, None, :]
    return acc / s


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
    B, KVH, G, D = q.shape
    Lk, _, _, T, _ = k.shape
    if not 0 <= layer < Lk:
        raise IndexError(f"layer {layer} out of range for {Lk} layers")
    if q.device.type == "cpu":
        return flash_decode_q8_staged_plain(q, k, v, ks, vs, k_new, v_new,
                                            layer, pos, block_t, dots)
    bt = resolve_block_t(block_t, T)
    if G > 8 or D > 128 or D % 16 or bt > 256:
        raise ValueError(f"the CUDA kernel takes G <= 8, D <= 128 with "
                         f"D % 16 == 0 and block_t <= 256; got G={G} D={D} "
                         f"block_t={bt}")
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError("the KV cache must be int8")
    qf = q.float().contiguous()
    ksf, vsf = ks.float(), vs.float()
    kn = _current_layer(k_new, layer).float().contiguous()
    vn = _current_layer(v_new, layer).float().contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    for t in (qf, k, v, ksf, vsf, kn, vn, pos32):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("attention operands must be contiguous and on "
                             "one device")
    layer_kv = B * KVH * T * D
    out = torch.empty((B, KVH, G, D), dtype=torch.float32, device=q.device)
    err = _build.library("flash_decode_staged").flash_decode_staged_launch(
        qf.data_ptr(), k.data_ptr() + layer * layer_kv,
        v.data_ptr() + layer * layer_kv,
        ksf.data_ptr() + layer * B * KVH * T * 4,
        vsf.data_ptr() + layer * B * KVH * T * 4,
        kn.data_ptr(), vn.data_ptr(), pos32.data_ptr(), out.data_ptr(),
        B, KVH, G, D, T, bt, _scale_f32(D), int(dots == "i8"),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_decode_staged")
    flash_decode_q8_staged.launches += 1
    return out


flash_decode_q8_staged.launches = 0


def _scale_f32(D: int) -> float:
    """The softmax scale ``1 / sqrt(D)`` as the f32 the kernels multiply by."""
    return float(np.float32(1.0 / (D ** 0.5)))


def flash_decode_q8_staged_xla(q, k, v, ks, vs, k_new, v_new, layer: int,
                               pos) -> torch.Tensor:
    """Exact-softmax twin of :func:`flash_decode_q8_staged` with f32 dots
    (the reference's ``flash_decode_q8_staged_xla``): cache tokens
    ``< pos`` plus the staged current token, one softmax over all."""
    B, KVH, G, D = q.shape
    kl, vl = k[layer].float(), v[layer].float()
    ksl, vsl = ks[layer].float(), vs[layer].float()
    kn = _current_layer(k_new, layer).float()
    vn = _current_layer(v_new, layer).float()
    T = kl.shape[2]
    qf = q.float()
    sqrt_d = torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    logits = torch.einsum("bhgd,bhtd->bhgt", qf, kl)
    logits = logits * (ksl[:, :, None, :] / sqrt_d)
    valid = (torch.arange(T, device=q.device)[None, None, None, :]
             < pos.to(q.device)[:, None, None, None])
    logits = torch.where(valid, logits, torch.full_like(logits, _NEG_INF))
    cur = torch.einsum("bhgd,bhd->bhg", qf, kn) / sqrt_d
    logits = torch.cat([logits, cur[..., None]], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    pv = probs[..., :T] * vsl[:, :, None, :]
    out = torch.einsum("bhgt,bhtd->bhgd", pv, vl)
    return out + probs[..., T:] * vn[:, :, None, :]
