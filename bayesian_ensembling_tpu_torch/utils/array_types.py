"""Array type aliases: plain typing aliases over numpy arrays and tensors
(counterpart of ``bayesian_ensembling_tpu/utils/array_types.py``)."""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

Array = tp.Union[np.ndarray, torch.Tensor]
Vector = Array  # shape (N,)
ColumnVector = Array  # shape (N, 1)
Matrix = Array  # shape (N, M)

__all__ = ["Array", "Vector", "ColumnVector", "Matrix"]
