"""Kernels of the prefill and decode steps: CUDA sources in ``csrc/``,
wrappers and plain PyTorch versions in ``kernels``, ``attention`` and
``megastep``."""
