"""Perplexity evaluation harness, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.evalm.
perplexity``: next-token negative log-likelihood over a token stream in
fixed-length windows (the WikiText-2 / C4 protocol), through
``models.llama.forward``, so a compressed model runs the kernels of its
serving mode on the card.

Over a device mesh (``parallel.mesh.make_mesh``; every rank holds the whole
model and calls the harness on the same stream) the windows of each batch
are data-parallel over the ``batch_axis`` ranks, and with a ``seq_axis``
each of its ranks also takes a contiguous span of every window's positions
(context parallelism): its queries attend the window's K/V gathered over
the seq group, one gather per layer. The ranks' NLL sums meet in one
all_reduce per mesh dim at the end, so every rank returns the number the
unsharded harness gives (up to the f32 order of the sums).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import comm


def _window_nll(params, tokens: torch.Tensor,
                config: ModelConfig) -> torch.Tensor:
    """Per-row NLL sums (nats) for (B, S) windows, predicting 1..S-1."""
    logits = llama.forward(params, tokens, config)
    logp = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
    return nll.sum(dim=1)


def _forward_span(params, tokens: torch.Tensor, start: int, n: int,
                  config: ModelConfig, group) -> torch.Tensor:
    """Logits (B, n, vocab) of positions ``start .. start + n - 1`` of the
    (B, S) windows ``tokens``: ``llama.forward`` on this rank's span of the
    positions, its queries attending the K/V of every position <= their own,
    gathered over ``group`` (whose ranks hold the spans in order)."""
    B, S = tokens.shape
    dev = tokens.device
    positions = start + torch.arange(n, device=dev)
    x = params.embed[tokens[:, start:start + n]].float()
    cos, sin = llama.rope_tables(config, positions[None])
    valid = torch.arange(S, device=dev)[None, :] <= positions[:, None]
    mask = llama._mask(valid)[None, None, None]
    for lp in params.layers:
        lin = llama._linears(lp)
        y = llama.rms_norm(x, lp.attn_norm, config.rms_norm_eps)
        q, k, v = llama._project_qkv(lin, y, config, cos, sin)
        kv = comm.gather_dim(torch.stack([k.float(), v.float()]), group, 2)
        attn = llama._attention(q, kv[0], kv[1], mask)
        x = llama._mlp_and_o(lin, x, attn.reshape(B, n, config.q_dim),
                             lp.mlp_norm, config)
    return llama._head(params, x, config)


def _span_nll(params, tokens: torch.Tensor, config: ModelConfig,
              seq_group) -> torch.Tensor:
    """Per-row NLL sums (nats) of this rank's span of the (B, S) windows
    (the predictions of its positions that have a next token)."""
    S = tokens.shape[1]
    n = S // comm.group_size(seq_group)
    start = comm.group_rank(seq_group) * n
    logits = _forward_span(params, tokens, start, n, config, seq_group)
    stop = min(start + n, S - 1)
    logp = torch.log_softmax(logits[:, :stop - start].float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, start + 1:stop + 1, None])[..., 0]
    return nll.sum(dim=1)


def _axis(mesh, name: str):
    if name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no dim {name!r} (dims "
                         f"{mesh.mesh_dim_names})")
    return comm.axis_group(mesh, name), comm.axis_size(mesh, name)


def evaluate_perplexity(params, token_stream: np.ndarray,
                        config: ModelConfig, window: int = 1024,
                        batch_size: int = 1, stride: Optional[int] = None,
                        mesh=None, batch_axis: str = "dp",
                        seq_axis: Optional[str] = None,
                        device="cuda") -> float:
    """Sliding-window perplexity of ``llama.ModelParams`` (on ``device``)
    over a 1-D token stream.

    Non-overlapping windows by default (``stride = window``); the last
    partial batch is padded with copies of the last window, which are left
    out of the average. With a ``mesh`` the windows of a batch shard over
    its ``batch_axis`` ranks (``batch_size`` must divide evenly) and, given
    ``seq_axis``, the positions of each window over that dim's ranks (see
    the module docstring).
    """
    dp_group = seq_group = None
    if mesh is not None:
        dp_group, dp = _axis(mesh, batch_axis)
        if batch_size % dp:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by mesh axis "
                f"'{batch_axis}' of size {dp}")
        if seq_axis is not None:
            seq_group, sp = _axis(mesh, seq_axis)
            if window % sp:
                raise ValueError(f"window {window} must be divisible by mesh "
                                 f"axis '{seq_axis}' of size {sp}")
    dev = resolve_device(device)
    stride = stride or window
    stream = np.asarray(token_stream).reshape(-1)
    starts = list(range(0, len(stream) - window + 1, stride))
    if not starts:
        raise ValueError(f"stream of {len(stream)} tokens shorter than "
                         f"window {window}")
    windows = np.stack([stream[s:s + window] for s in starts])
    n = len(windows)
    pad = (-n) % batch_size
    if pad:
        windows = np.concatenate([windows,
                                  np.repeat(windows[-1:], pad, axis=0)])
    lo, hi = 0, batch_size
    if dp_group is not None:
        hi = batch_size // comm.group_size(dp_group)
        lo = comm.group_rank(dp_group) * hi
        hi += lo
    total_nll, total_tok = 0.0, 0
    for i in range(0, len(windows), batch_size):
        n_real = min(batch_size, n - i)
        total_tok += n_real * (window - 1)
        toks = torch.from_numpy(
            windows[i + lo:i + hi].astype(np.int64)).to(dev)
        if seq_group is None:
            row_nll = _window_nll(params, toks, config)
        else:
            row_nll = _span_nll(params, toks, config, seq_group)
        # padded rows are left out
        total_nll += float(row_nll[:max(0, min(hi, n_real) - lo)].sum())
    if mesh is not None:
        t = torch.tensor([total_nll], dtype=torch.float64, device=dev)
        for group in (dp_group, seq_group):
            if group is not None:
                t = comm.all_sum(t, group)
        total_nll = float(t[0])
    return float(np.exp(total_nll / max(total_tok, 1)))
