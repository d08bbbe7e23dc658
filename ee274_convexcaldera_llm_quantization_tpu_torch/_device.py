"""Device resolution shared by every creation function and entry point."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise when it names CUDA and no card
    is present, so nothing quietly runs on the CPU.

    Also turns TF32 off for matmuls and convolutions: the port's f32 dots
    stand in for the reference's full-f32 ``preferred_element_type`` dots.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
