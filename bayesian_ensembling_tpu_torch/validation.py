"""Perfect-model validation harness (counterpart of
``bayesian_ensembling_tpu/validation.py``).

For now it holds :func:`load_model_collection`; the leave-one-out harness
(``PerfectModelTest``, ``batched_pmt``) is ROADMAP.md item A7b-1.
"""

from __future__ import annotations

import typing as tp

import torch

from bayesian_ensembling_tpu_torch.data import ModelCollection

__all__ = ["load_model_collection"]


def load_model_collection(
    path: str, device: tp.Union[str, torch.device] = "cuda"
) -> ModelCollection:
    """Load a checkpointed :class:`ModelCollection` (an npz archive written
    by either package's ``ModelCollection.save``); fitted posteriors'
    moments are placed on ``device``."""
    return ModelCollection.load(path, device=device)
