"""Kernels of the decode step: CUDA sources in ``csrc/``, wrappers and plain
PyTorch versions in ``kernels`` and ``attention``."""
