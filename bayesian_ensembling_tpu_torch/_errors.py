"""The error every entry point shares: a CUDA device asked for where there
is none."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device, who: str) -> torch.device:
    """``torch.device(device)``; raises when it is a CUDA device and CUDA is
    not available (nothing falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA is not available; pass device='cpu' to run on the CPU")
    return device
