"""Perplexity evaluation harness, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.evalm.
perplexity``: next-token negative log-likelihood over a token stream in
fixed-length windows (the WikiText-2 / C4 protocol), through
``models.llama.forward``, so a compressed model runs the kernels of its
serving mode on the card. Sharding over a device mesh is not ported yet.
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


def _window_nll(params, tokens: torch.Tensor,
                config: ModelConfig) -> torch.Tensor:
    """Per-row NLL sums (nats) for (B, S) windows, predicting 1..S-1."""
    logits = llama.forward(params, tokens, config)
    logp = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0]
    return nll.sum(dim=1)


def evaluate_perplexity(params, token_stream: np.ndarray,
                        config: ModelConfig, window: int = 1024,
                        batch_size: int = 1, stride: Optional[int] = None,
                        mesh=None, device="cuda") -> float:
    """Sliding-window perplexity of ``llama.ModelParams`` (on ``device``)
    over a 1-D token stream.

    Non-overlapping windows by default (``stride = window``); the last
    partial batch is padded with copies of the last window, which are left
    out of the average.
    """
    if mesh is not None:
        raise NotImplementedError("evaluate_perplexity over a device mesh is "
                                  "not ported yet (ROADMAP.md, Queue A item "
                                  "19)")
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
    total_nll, total_tok = 0.0, 0
    for i in range(0, len(windows), batch_size):
        toks = torch.from_numpy(windows[i:i + batch_size].astype(np.int64))
        row_nll = _window_nll(params, toks.to(dev), config).cpu().numpy()
        n_real = min(batch_size, n - i)
        total_nll += float(row_nll[:n_real].sum())
        total_tok += n_real * (window - 1)
    return float(np.exp(total_nll / max(total_tok, 1)))
