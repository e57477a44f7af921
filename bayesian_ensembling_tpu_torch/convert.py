"""Carry fitted GP hyperparameters between the JAX package and the port.

Both sides hold the same unconstrained (softplus) leaves, ``raw_lengthscale``
and ``raw_variance``, one value per model.  The exchange format is numpy:
``jax.tree.map(np.asarray, params)`` on the JAX side, and
``GPParams(**gp_params_to_numpy(p))`` to go back.  This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_ensembling_tpu_torch.ops.gp import BatchedGPParams

__all__ = ["gp_params_from_jax", "gp_params_to_numpy"]


def gp_params_from_jax(
    raw_lengthscale: np.ndarray,
    raw_variance: np.ndarray,
    device: torch.device | str,
    dtype: torch.dtype,
) -> BatchedGPParams:
    """A :class:`BatchedGPParams` from the JAX ``GPParams`` leaves, each
    ``(M,)``, as numpy arrays."""
    return BatchedGPParams(
        torch.tensor(np.array(raw_lengthscale), dtype=dtype, device=device),
        torch.tensor(np.array(raw_variance), dtype=dtype, device=device),
    )


def gp_params_to_numpy(params: BatchedGPParams) -> dict[str, np.ndarray]:
    """The leaves as numpy arrays, keyed by the JAX ``GPParams`` field names."""
    return {
        "raw_lengthscale": params.raw_lengthscale.detach().cpu().numpy(),
        "raw_variance": params.raw_variance.detach().cpu().numpy(),
    }
