"""Fused-projection W4A8 decode step, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.models.fused``
for the serving main path: q/k/v and gate/up concatenate along the output
dimension so each layer makes four W4A8 matmul launches (qkv, o, gate+up,
down) and one staged flash-decode attention launch, all hand-written CUDA
kernels on the card; the int8 lm_head adds one int8 matmul launch per step.
Activation quantization, RMSNorm, RoPE, KV quantization, SiLU and the
low-rank factor dots stay plain PyTorch, as the reference leaves them to
XLA.

Fusion keeps the math of the unfused projections: packed codes, row scales
and biases concatenate along N; the ``R`` factors concatenate along the rank
axis (one ``(B, sum_ranks)`` dot) while the ``L`` factors stay per
projection; each projection's ``global_scale`` applies to its output slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed import (
    CalderaLinear, DenseLinear, quantize_factors_int8, quantize_linear_int8)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.llama import (
    HeadMajorQuantKVCache)
from ee274_convexcaldera_llm_quantization_tpu_torch.models.stacked import (
    StackedModelParams, _low_rank_layer)
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import attention as AT
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as K


@dataclasses.dataclass
class FusedW4A8Linear:
    """Several same-input w4a8 :class:`CalderaLinear` projections fused
    along the output dimension (all tensors layer-stacked)."""

    packed: torch.Tensor               # (layers, sum_N, K/f) uint8
    scales: torch.Tensor               # (layers, sum_N, 1) f32
    R: torch.Tensor                    # (layers, sum_ranks, K) bf16 | int8
    Ls: Tuple[torch.Tensor, ...]       # per-projection (layers, N_i, r_i)
    global_scale: torch.Tensor         # (layers, n_proj) f32
    b: Optional[torch.Tensor] = None   # (layers, sum_N) or None
    R_scale: Optional[torch.Tensor] = None                # (layers, sum_r, 1)
    L_scales: Optional[Tuple[torch.Tensor, ...]] = None   # (layers, N_i, 1)
    num_bits: int = 4
    splits: Tuple[int, ...] = ()
    ranks: Tuple[int, ...] = ()


@dataclasses.dataclass
class FusedLayerStack:
    attn_norm: torch.Tensor            # (layers, hidden)
    qkv: FusedW4A8Linear
    o_proj: CalderaLinear              # stacked w4a8
    mlp_norm: torch.Tensor
    gateup: FusedW4A8Linear
    down_proj: CalderaLinear           # stacked w4a8


@dataclasses.dataclass
class FusedStackedParams:
    embed: torch.Tensor
    layers: FusedLayerStack
    final_norm: torch.Tensor
    lm_head: Optional[object]


def _fuse_group(lins) -> FusedW4A8Linear:
    """Fuse stacked w4a8 CalderaLinears sharing the same input."""
    for lin in lins:
        if not isinstance(lin, CalderaLinear) or lin.mode != "w4a8":
            raise ValueError("fused path requires w4a8 CalderaLinear "
                             f"projections, got {type(lin).__name__} "
                             f"mode={getattr(lin, 'mode', None)}")
    bits = {lin.num_bits for lin in lins}
    if len(bits) != 1:
        raise ValueError(f"fused projections must share num_bits, got {bits}")
    packed = torch.cat([lin.packed for lin in lins], dim=1)
    scales = torch.cat([lin.scales for lin in lins], dim=1)
    facs = [lin.factors() for lin in lins]
    R = torch.cat([R_i for _, R_i in facs], dim=1).to(torch.bfloat16)
    Ls = tuple(L_i.to(torch.bfloat16) for L_i, _ in facs)
    gs = torch.stack([lin.global_scale.reshape(-1) for lin in lins], dim=1)
    if any(lin.b is not None for lin in lins):
        b = torch.cat(
            [lin.b if lin.b is not None
             else torch.zeros(lin.packed.shape[:2], dtype=torch.float32,
                              device=lin.packed.device)
             for lin in lins], dim=1)
    else:
        b = None
    return FusedW4A8Linear(
        packed=packed, scales=scales, R=R, Ls=Ls, global_scale=gs, b=b,
        num_bits=lins[0].num_bits,
        splits=tuple(lin.packed.shape[1] for lin in lins),
        ranks=tuple(lin.R.shape[1] for lin in lins))


def fuse_stacked(params: StackedModelParams) -> FusedStackedParams:
    """Convert stacked w4a8 params to the fused-projection layout."""
    lp = params.layers
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        lin = getattr(lp, name)
        if not isinstance(lin, CalderaLinear) or lin.mode != "w4a8":
            raise ValueError(f"{name} must be a stacked w4a8 CalderaLinear")
    layers = FusedLayerStack(
        attn_norm=lp.attn_norm,
        qkv=_fuse_group([lp.q_proj, lp.k_proj, lp.v_proj]),
        o_proj=lp.o_proj,
        mlp_norm=lp.mlp_norm,
        gateup=_fuse_group([lp.gate_proj, lp.up_proj]),
        down_proj=lp.down_proj)
    return FusedStackedParams(embed=params.embed, layers=layers,
                              final_norm=params.final_norm,
                              lm_head=params.lm_head)


def _quantize_fused_factors(fp: FusedW4A8Linear) -> FusedW4A8Linear:
    if fp.R_scale is not None:
        return fp
    R8, Rs = K.quantize_int8_rowwise(fp.R)
    pairs = [K.quantize_int8_rowwise(L) for L in fp.Ls]
    return dataclasses.replace(
        fp, R=R8, R_scale=Rs, Ls=tuple(c for c, _ in pairs),
        L_scales=tuple(s for _, s in pairs))


def quantize_factors_int8_fused(params: FusedStackedParams,
                                lm_head_int8: bool = True,
                                fuse_factor_kernel=False
                                ) -> FusedStackedParams:
    """int8-quantize all low-rank factors (and optionally the lm_head, or
    the tied embedding as a head) of a fused model.

    Only the ``"xla"`` factor path (``fuse_factor_kernel`` False / "xla":
    per-layer factor dots outside the packed kernel) is ported.
    """
    fk = {False: "xla", True: "lr"}.get(fuse_factor_kernel,
                                        fuse_factor_kernel)
    if fk in ("l", "lr"):
        raise NotImplementedError(
            f"factor path {fk!r} is not ported yet (ROADMAP.md, Queue B "
            "items 10-11)")
    if fk != "xla":
        raise ValueError(f"unknown factor kernel {fuse_factor_kernel!r}")
    lp = params.layers
    layers = FusedLayerStack(
        attn_norm=lp.attn_norm,
        qkv=_quantize_fused_factors(lp.qkv),
        o_proj=quantize_factors_int8(lp.o_proj),
        mlp_norm=lp.mlp_norm,
        gateup=_quantize_fused_factors(lp.gateup),
        down_proj=quantize_factors_int8(lp.down_proj))
    lm_head = params.lm_head
    if lm_head_int8:
        if lm_head is None:
            lm_head = quantize_linear_int8(DenseLinear(w=params.embed))
        elif isinstance(lm_head, DenseLinear):
            lm_head = quantize_linear_int8(lm_head)
    return FusedStackedParams(embed=params.embed, layers=layers,
                              final_norm=params.final_norm, lm_head=lm_head)


def _apply_fused(fp: FusedW4A8Linear, l: int, y: torch.Tensor):
    """One W4A8 launch + per-projection low-rank adds; returns a tuple of
    (B, N_i) outputs in fusion order."""
    yq = K.quantized_matmul_w4a8_stacked(y, fp.packed, fp.scales, l,
                                         fp.num_bits)
    xr = y.to(torch.bfloat16).float() @ fp.R[l].to(torch.bfloat16).float().T
    if fp.R_scale is not None:
        xr = xr * fp.R_scale[l][:, 0][None, :]
    gs_l = fp.global_scale[l]
    b_l = None if fp.b is None else fp.b[l]
    outs = []
    off_n = off_r = 0
    for i, (N_i, r_i) in enumerate(zip(fp.splits, fp.ranks)):
        ylr = (xr[:, off_r:off_r + r_i].to(torch.bfloat16).float()
               @ fp.Ls[i][l].to(torch.bfloat16).float().T)
        if fp.L_scales is not None:
            ylr = ylr * fp.L_scales[i][l][:, 0][None, :]
        out = (yq[:, off_n:off_n + N_i] + ylr) * gs_l[i]
        if b_l is not None:
            out = out + b_l[off_n:off_n + N_i][None, :]
        outs.append(out)
        off_n += N_i
        off_r += r_i
    return tuple(outs)


def _apply_plain(lin: CalderaLinear, l: int, y: torch.Tensor):
    """Single stacked w4a8 projection: packed matmul + low-rank term."""
    out = (K.quantized_matmul_w4a8_stacked(y, lin.packed, lin.scales, l,
                                           lin.num_bits)
           + _low_rank_layer(lin, l, y))
    out = out * lin.global_scale[l]
    if lin.b is not None:
        out = out + lin.b[l][None, :]
    return out


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"{item})")


def _commit(cache: HeadMajorQuantKVCache, staging, pos: torch.Tensor):
    """Write each row's staged K/V (all layers) at column ``pos[b]`` of the
    cache, in place: one indexed write per cache tensor. Positions past the
    end clamp to the last column, as the reference's dynamic_update_slice
    does."""
    sk, sks, sv, svs = staging                 # (L, B, KVH[, D])
    T = cache.k.shape[3]
    rows = torch.arange(pos.shape[0], device=pos.device)
    col = pos.long().clamp(0, T - 1)
    # advanced indices on dims 1 and 3 move to the front: (B, L, KVH[, D])
    cache.k[:, rows, :, col] = sk.transpose(0, 1)
    cache.v[:, rows, :, col] = sv.transpose(0, 1)
    cache.k_scale[:, rows, :, col] = sks.transpose(0, 1)
    cache.v_scale[:, rows, :, col] = svs.transpose(0, 1)


def decode_step_fused(params: FusedStackedParams, tokens: torch.Tensor,
                      pos: torch.Tensor, cache: HeadMajorQuantKVCache,
                      config: ModelConfig, staged_kv="uniform",
                      mlp_kernel: bool = False,
                      attn_o_kernel: bool = False,
                      attn_dots: str = "f32",
                      head_pallas: bool = False,
                      attn_kernel: str = "row",
                      tp_axis: Optional[str] = None,
                      proj_kernel: str = "grid"):
    """Batched decode step on the fused-projection W4A8 path.

    ``tokens`` (B,) int and ``pos`` (B,) int32 on the params' device; the
    step computes on that device. Returns ``(logits (B, vocab) f32,
    cache)``. The cache tensors are **updated in place** (the reference
    donates them): this step's K/V are staged per layer and committed once
    at the end, each row at its own ``pos[b]``.

    ``staged_kv``: "uniform" (the bench's lockstep batch) or True (ragged
    positions). The reference's uniform commit writes column ``pos[0]`` for
    every row and guards against ragged positions by falling back to the
    per-row commit; here both modes take the per-row indexed write, one
    launch per cache tensor, so ragged positions stay correct under
    "uniform" by construction. ``attn_dots``: "i8" (the main path) or
    "f32". ``head_pallas`` is accepted and has no effect: the int8 head
    always runs the int8 matmul kernel on the card and its plain version on
    the CPU. Other flag values are not ported yet and raise.
    """
    if staged_kv not in ("uniform", True):
        raise _not_ported(f"staged_kv={staged_kv!r} (the inline path)",
                          "Queue B item 4 and Queue A item 6")
    if not isinstance(cache, HeadMajorQuantKVCache):
        raise _not_ported(f"the {type(cache).__name__} cache",
                          "Queue A item 3")
    if mlp_kernel:
        raise _not_ported("mlp_kernel=True", "Queue B item 12")
    if attn_o_kernel:
        raise _not_ported("attn_o_kernel=True", "Queue B item 13")
    if attn_kernel == "ab":
        raise _not_ported("attn_kernel='ab'", "Queue B item 8")
    if attn_kernel != "row":
        raise ValueError(f"unknown attn_kernel {attn_kernel!r}")
    if tp_axis is not None:
        raise _not_ported("tp_axis", "Queue A item 19")
    if proj_kernel == "persistent":
        raise _not_ported("proj_kernel='persistent'", "Queue B item 14")
    if proj_kernel != "grid":
        raise ValueError(f"unknown proj_kernel {proj_kernel!r}")
    del head_pallas
    resolve_device(tokens.device)
    lp = params.layers
    B = tokens.shape[0]
    Lk, KVH, D = config.num_layers, config.num_kv_heads, config.head_dim
    H = config.num_heads
    kv_groups = H // KVH
    dev = tokens.device
    x = params.embed[tokens].float()
    cos, sin = llama.rope_tables(config, pos[:, None])
    staging = (torch.empty((Lk, B, KVH, D), dtype=torch.int8, device=dev),
               torch.empty((Lk, B, KVH), dtype=torch.float32, device=dev),
               torch.empty((Lk, B, KVH, D), dtype=torch.int8, device=dev),
               torch.empty((Lk, B, KVH), dtype=torch.float32, device=dev))
    sk, sks, sv, svs = staging
    for l in range(Lk):
        y = llama.rms_norm(x, lp.attn_norm[l], config.rms_norm_eps)
        q, k, v = _apply_fused(lp.qkv, l, y)
        q = llama.apply_rope(q.reshape(B, 1, H, D), cos, sin)
        k = llama.apply_rope(k.reshape(B, 1, KVH, D), cos, sin)
        v = v.reshape(B, 1, KVH, D)
        kq, ksc = llama.quantize_kv(k[:, 0])
        vq, vsc = llama.quantize_kv(v[:, 0])
        sk[l], sks[l], sv[l], svs[l] = kq, ksc, vq, vsc
        kf = kq.float() * ksc[..., None]
        vf = vq.float() * vsc[..., None]
        attn = AT.flash_decode_q8_staged(
            q[:, 0].reshape(B, KVH, kv_groups, D), cache.k, cache.v,
            cache.k_scale, cache.v_scale, kf, vf, l, pos,
            dots=attn_dots).reshape(B, config.q_dim)
        x = x + _apply_plain(lp.o_proj, l, attn)
        y = llama.rms_norm(x, lp.mlp_norm[l], config.rms_norm_eps)
        gate, up = _apply_fused(lp.gateup, l, y)
        x = x + _apply_plain(lp.down_proj, l, gate * torch.sigmoid(gate) * up)
    _commit(cache, staging, pos)
    logits = llama._logits(x, params.embed, params.final_norm,
                           params.lm_head, config)
    return logits, cache
