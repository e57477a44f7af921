"""Carry state between the JAX package and the port: fitted GP
hyperparameters, posteriors and fitted collections.

The exchange format is numpy throughout, and this module imports no JAX:

  * hyperparameters: both sides hold the same unconstrained (softplus)
    leaves, ``raw_lengthscale`` and ``raw_variance``, one value per model
    (``jax.tree.map(np.asarray, params)`` on the JAX side, and
    ``GPParams(**gp_params_to_numpy(p))`` to go back);
  * a posterior: ``Posterior.to_arrays()`` of either package (``mean`` plus
    ``cov`` or ``var``) and the template ``DimArray``;
  * a fitted collection: ``ModelCollection._to_blobs()`` of either package,
    the arrays its npz checkpoint holds.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch.coords import DimArray
from bayesian_ensembling_tpu_torch.data import ModelCollection, Posterior
from bayesian_ensembling_tpu_torch.ops.gp import BatchedGPParams

__all__ = [
    "gp_params_from_jax",
    "gp_params_to_numpy",
    "dimarray_from_jax",
    "posterior_from_jax",
    "collection_from_jax",
]


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


def dimarray_from_jax(da) -> DimArray:
    """The port's :class:`DimArray` from the JAX package's (or any object
    with ``values``, ``dims``, ``coords`` and ``name``)."""
    coords = {k: np.asarray(v) for k, v in da.coords.items()}
    return DimArray(np.asarray(da.values), tuple(da.dims), coords, name=da.name)


def posterior_from_jax(
    arrays: tp.Mapping[str, np.ndarray], template, device: torch.device | str
) -> Posterior:
    """The port's :class:`Posterior` from ``Posterior.to_arrays()`` of the
    JAX package and its template, the moments on ``device`` in the arrays'
    own dtype."""
    return Posterior.from_arrays(arrays, dimarray_from_jax(template), device=device)


def collection_from_jax(
    blobs: tp.Mapping[str, np.ndarray], device: torch.device | str
) -> ModelCollection:
    """The port's :class:`ModelCollection`, fitted posteriors included, from
    ``ModelCollection._to_blobs()`` of the JAX package."""
    return ModelCollection._from_blobs(blobs, list(blobs), device=device)
