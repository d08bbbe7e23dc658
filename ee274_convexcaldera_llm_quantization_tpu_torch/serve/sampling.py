"""Batched token sampling: greedy / temperature / top-k / top-p, per row.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.serve.sampling``:

- ``temperature <= 0`` is greedy (argmax) for that row;
- ``top_k > 0`` keeps the k highest-probability tokens (ties at the
  threshold are all kept);
- ``top_p < 1`` keeps the smallest prefix of the probability-sorted
  vocabulary whose *exclusive* cumulative mass is below ``top_p`` (the
  highest-probability token is always kept).

Draws come from an explicit ``torch.Generator`` on the logits' device, so
they cannot equal ``jax.random``'s: the distribution is the same, the bits
are not.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _per_row(value, B: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=dtype, device=device).reshape(
        -1).expand(B)


def filter_logits(logits: torch.Tensor, temperature, top_k,
                  top_p) -> torch.Tensor:
    """Temperature-scale and top-k/top-p-filter logits per row.

    ``logits`` (B, V) float; ``temperature``/``top_p`` (B,) or scalars,
    float; ``top_k`` (B,) or a scalar, int (0 disables). Returns (B, V) f32
    filtered logits (dropped entries at -1e30) whose softmax is the
    sampling distribution.
    """
    logits = logits.float()
    B, V = logits.shape
    dev = logits.device
    temperature = _per_row(temperature, B, torch.float32, dev)
    top_k = _per_row(top_k, B, torch.int64, dev)
    top_p = _per_row(top_p, B, torch.float32, dev)

    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values

    # top-k -> per-row value threshold (k-th largest scaled logit)
    k = torch.where(top_k <= 0, torch.full_like(top_k, V), top_k).clamp(1, V)
    thr_k = torch.gather(sorted_desc, 1, (k - 1)[:, None])

    # top-p -> smallest kept value in the sorted prefix whose exclusive
    # cumulative probability stays below p (row head always kept)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = cum_excl < top_p.clamp_min(1e-6)[:, None]
    thr_p = torch.where(keep_sorted, sorted_desc,
                        torch.full_like(sorted_desc, float("inf"))).amin(
                            dim=-1, keepdim=True)

    keep = (scaled >= thr_k) & (scaled >= thr_p)
    return torch.where(keep, scaled, torch.full_like(scaled, _NEG_INF))


def sample_logits(generator: torch.Generator, logits: torch.Tensor,
                  temperature, top_k, top_p) -> torch.Tensor:
    """One token per row: argmax where ``temperature <= 0``, else a draw
    from the softmax of :func:`filter_logits`. Only the rows that sample
    draw from ``generator`` (a batch of greedy rows consumes no
    randomness). Returns (B,) int32 on the logits' device."""
    logits = logits.float()
    B = logits.shape[0]
    temperature = _per_row(temperature, B, torch.float32, logits.device)
    out = logits.argmax(dim=-1)
    hot = torch.nonzero(temperature > 0).flatten()
    if hot.numel():
        filtered = filter_logits(logits[hot], temperature[hot],
                                 _per_row(top_k, B, torch.int64,
                                          logits.device)[hot],
                                 _per_row(top_p, B, torch.float32,
                                          logits.device)[hot])
        draws = torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                                  generator=generator)[:, 0]
        out[hot] = draws
    return out.to(torch.int32)
