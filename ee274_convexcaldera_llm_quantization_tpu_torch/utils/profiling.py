"""Tracing and profiling utilities, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.utils.
profiling``: named phase timers for the compression pipeline (a phase
that used the card ends with ``torch.cuda.synchronize()``, so its time
holds its kernels), a ``torch.profiler`` trace scope, and a structured
event log.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch


class PhaseTimer:
    """Named wall-clock phases with a JSON-serializable summary. Once CUDA
    is in use, each phase synchronises the card before its clock stops."""

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self._order: List[str] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.time() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if name not in self._order:
                self._order.append(name)

    def summary(self) -> Dict[str, float]:
        return {name: round(self.phases[name], 4) for name in self._order}

    def __str__(self):
        return json.dumps(self.summary())


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """``torch.profiler`` scope over the CPU and, where present, the card,
    writing a Chrome trace (``trace.json``) under ``log_dir``; nothing when
    ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class EventLog:
    """Structured replacement for print/CSV side-channel telemetry."""

    def __init__(self):
        self.events: List[dict] = []

    def log(self, kind: str, **fields):
        self.events.append({"kind": kind, "t": time.time(), **fields})

    def of_kind(self, kind: str) -> List[dict]:
        return [e for e in self.events if e["kind"] == kind]

    def dump(self, path: str):
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")
