"""Compression metrics and plots, in PyTorch's package.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.evalm.metrics``:
exact bits per parameter from the true (m, n) shape (the reference
project's square-matrix approximation fixed), accuracy and perplexity
deltas, relative error and singular values (f64, on the tensors' device),
compression ratio and size. The ``plot_*`` functions import ``matplotlib``
when called and raise ``ImportError`` where it is absent.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class CompressionMetrics:
    """Aggregate metrics of one compressed model or layer."""

    bits_per_parameter: float
    accuracy_drop: Optional[float] = None
    perplexity_increase: Optional[float] = None
    duality_gap: Optional[float] = None
    effective_rank: Optional[float] = None
    relative_error: Optional[float] = None
    compression_ratio: Optional[float] = None
    model_size_mb: Optional[float] = None


def compute_bits_per_parameter(
    shape: Tuple[int, int],
    avg_bits: float,
    rank: int = 0,
    rank_bits: float = 16.0,
    scale_bits_per_block: float = 16.0,
    block_size: Optional[int] = None,
) -> float:
    """Exact bits/parameter for a ``Q + L R`` compressed (m, n) layer.

    ``(rank (m + n) rank_bits + m n avg_bits + scale overhead) / (m n)``
    — the reference approximates m = n = sqrt(m n) (``metrics.py:55-57``);
    here the true shape is used and blockwise-scale overhead is included
    when ``block_size`` is given.
    """
    m, n = shape
    total = m * n * avg_bits + rank * (m + n) * rank_bits
    if block_size:
        total += (m * n / block_size) * scale_bits_per_block
    return total / (m * n)


def compute_accuracy_drop(acc_original: float, acc_compressed: float) -> float:
    return acc_original - acc_compressed


def compute_perplexity_increase(ppl_original: float,
                                ppl_compressed: float) -> float:
    return ppl_compressed - ppl_original


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float64)


def compute_relative_error(W, W_hat) -> float:
    """``||W_hat - W||_F / ||W||_F`` in f64 (tensors or numpy arrays)."""
    W = _f64(W)
    W_hat = _f64(W_hat).to(W.device)
    return float(torch.linalg.norm(W_hat - W)
                 / max(float(torch.linalg.norm(W)), 1e-30))


def compute_compression_ratio(bits_per_parameter: float,
                              original_bits: float = 16.0) -> float:
    """Ratio against an FP16 original."""
    return original_bits / max(bits_per_parameter, 1e-30)


def compute_model_size_mb(num_params: int, bits_per_parameter: float) -> float:
    return num_params * bits_per_parameter / 8 / 1024 / 1024


def evaluate_compression(
    shape: Tuple[int, int],
    avg_bits: float,
    rank: int = 0,
    rank_bits: float = 16.0,
    W=None,
    W_hat=None,
    acc_original: Optional[float] = None,
    acc_compressed: Optional[float] = None,
    ppl_original: Optional[float] = None,
    ppl_compressed: Optional[float] = None,
    duality_gap: Optional[float] = None,
    effective_rank: Optional[float] = None,
    block_size: Optional[int] = None,
) -> CompressionMetrics:
    """Aggregate everything into one record."""
    bpp = compute_bits_per_parameter(shape, avg_bits, rank, rank_bits,
                                     block_size=block_size)
    m, n = shape
    return CompressionMetrics(
        bits_per_parameter=bpp,
        accuracy_drop=(compute_accuracy_drop(acc_original, acc_compressed)
                       if acc_original is not None
                       and acc_compressed is not None else None),
        perplexity_increase=(compute_perplexity_increase(ppl_original,
                                                         ppl_compressed)
                             if ppl_original is not None
                             and ppl_compressed is not None else None),
        duality_gap=duality_gap,
        effective_rank=effective_rank,
        relative_error=(compute_relative_error(W, W_hat)
                        if W is not None and W_hat is not None else None),
        compression_ratio=compute_compression_ratio(bpp),
        model_size_mb=compute_model_size_mb(m * n, bpp),
    )


def compute_singular_values(W) -> torch.Tensor:
    """Descending singular values, f64, on ``W``'s device."""
    return torch.linalg.svdvals(_f64(W))


# ---------------------------------------------------------------------------
# Plotting (matplotlib, headless backend)
# ---------------------------------------------------------------------------

def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_bit_allocation_heatmap(bit_allocations: np.ndarray,
                                layer_names: Optional[Sequence[str]] = None,
                                save_path: Optional[str] = None):
    """Heatmap of per-layer/group bit allocations."""
    plt = _plt()
    arr = np.atleast_2d(np.asarray(bit_allocations, float))
    fig, ax = plt.subplots(figsize=(10, max(2, 0.3 * arr.shape[0])))
    im = ax.imshow(arr, aspect="auto", cmap="viridis")
    fig.colorbar(im, ax=ax, label="bits")
    if layer_names is not None:
        ax.set_yticks(range(len(layer_names)))
        ax.set_yticklabels(layer_names, fontsize=6)
    ax.set_xlabel("group")
    ax.set_title("Per-group bit allocation")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_accuracy_vs_bits(bits: Sequence[float], accuracies: Sequence[float],
                          labels: Optional[Sequence[str]] = None,
                          save_path: Optional[str] = None):
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(bits, accuracies, "o-")
    if labels:
        for b, a, l in zip(bits, accuracies, labels):
            ax.annotate(l, (b, a), fontsize=7)
    ax.set_xlabel("bits / parameter")
    ax.set_ylabel("accuracy")
    ax.set_title("Accuracy vs bits")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_loss_vs_rank(ranks: Sequence[float], losses: Sequence[float],
                      save_path: Optional[str] = None):
    plt = _plt()
    fig, ax = plt.subplots()
    ax.semilogy(ranks, losses, "o-")
    ax.set_xlabel("rank")
    ax.set_ylabel("loss")
    ax.set_title("Loss vs rank")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_singular_value_spectra(spectra: Dict[str, np.ndarray],
                                save_path: Optional[str] = None):
    """Overlaid log-scale singular value spectra."""
    plt = _plt()
    fig, ax = plt.subplots()
    for name, s in spectra.items():
        ax.semilogy(np.asarray(torch.as_tensor(s).cpu()), label=name)
    ax.set_xlabel("index")
    ax.set_ylabel("singular value")
    ax.legend(fontsize=7)
    ax.set_title("Singular value spectra")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path
