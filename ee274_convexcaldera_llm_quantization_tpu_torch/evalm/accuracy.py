"""Yes/no QA accuracy harness (POPE-style evaluation), in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.evalm.
accuracy``: generate greedily (``llama.generate_greedy``, so a compressed
model runs its kernels on the card), take the first yes/no word of the
detokenized text, compare with the label, and go on past an example whose
text cannot be decoded or parsed. Unlike the reference's bare ``except
Exception`` around the whole example, only the caller's ``detokenize`` and
the parsing are guarded, and only against the errors a decoder raises: a
failed generation (a kernel launch, a CUDA error) propagates (ROADMAP.md,
R13).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch._device import (
    resolve_device)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
    ModelConfig)

_YESNO = re.compile(r"\b(yes|no)\b", re.IGNORECASE)
# what a detokenizer raises on ids it cannot decode (an unknown id, bad
# bytes, a wrong type); RuntimeError, and with it every torch.cuda error,
# is not among them
DECODE_ERRORS = (KeyError, IndexError, ValueError, TypeError)


def extract_yes_no(text: str) -> Optional[str]:
    """First yes/no word in the generated text."""
    m = _YESNO.search(text)
    return m.group(1).lower() if m else None


@dataclasses.dataclass
class QAExample:
    prompt_tokens: np.ndarray
    label: str                     # "yes" | "no"


@dataclasses.dataclass
class AccuracyResult:
    accuracy: float
    num_correct: int
    num_evaluated: int
    num_failed: int                # unparseable or undecodable examples
    per_example: List[Tuple[int, Optional[str], str]]


def evaluate_yes_no_accuracy(
    params,
    examples: Sequence[QAExample],
    config: ModelConfig,
    detokenize: Callable[[Sequence[int]], str],
    max_new_tokens: int = 200,
    progress: Optional[Callable[[int, float], None]] = None,
    device="cuda",
) -> AccuracyResult:
    """Greedy generation on ``device`` (the params' device) and yes/no
    extraction per example; an example whose generated ids ``detokenize``
    cannot decode counts as failed."""
    dev = resolve_device(device)
    correct = 0
    failed = 0
    per_example = []
    for i, ex in enumerate(examples):
        prompt = torch.as_tensor(np.asarray(ex.prompt_tokens),
                                 dtype=torch.int64, device=dev)[None, :]
        out = llama.generate_greedy(params, prompt, max_new_tokens, config)
        gen = out[0, prompt.shape[1]:].cpu().tolist()
        try:
            answer = extract_yes_no(detokenize(gen))
        except DECODE_ERRORS:
            answer = None
        if answer is None:
            failed += 1
        elif answer == ex.label:
            correct += 1
        per_example.append((i, answer, ex.label))
        if progress is not None:
            progress(i, correct / max(i + 1, 1))
    n = len(examples)
    return AccuracyResult(
        accuracy=correct / max(n, 1),
        num_correct=correct,
        num_evaluated=n,
        num_failed=failed,
        per_example=per_example,
    )
