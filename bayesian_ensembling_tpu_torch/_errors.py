"""The errors every entry point shares: an option of the JAX package that
the port lacks, and a CUDA device asked for where there is none."""

from __future__ import annotations

import torch


def not_ported(what: str, roadmap_item: str) -> NotImplementedError:
    """``NotImplementedError`` naming the ROADMAP.md item that will port ``what``."""
    return NotImplementedError(
        f"{what} is not ported to bayesian_ensembling_tpu_torch yet "
        f"(ROADMAP.md item {roadmap_item}); use bayesian_ensembling_tpu for it"
    )


def resolve_device(device: str | torch.device, who: str) -> torch.device:
    """``torch.device(device)``; raises when it is a CUDA device and CUDA is
    not available (nothing falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA is not available; pass device='cpu' to run on the CPU")
    return device
