"""Carry state between the JAX package and the port: fitted GP
hyperparameters, posteriors and fitted collections.

The exchange format is numpy throughout, and this module imports no JAX:

  * hyperparameters: both sides hold the same unconstrained (softplus)
    leaves, ``raw_lengthscale`` and ``raw_variance``, one value per model,
    or per model and cell on the gridded surface
    (``jax.tree.map(np.asarray, params)`` on the JAX side, and
    ``GPParams(**gp_params_to_numpy(p))`` to go back);
  * SVGP parameters (``ops/svgp.py``): the same dict of leaves on both
    sides (``raw_ls``, ``raw_var``, ``z``, ``m``, ``ls_flat``);
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
    "gridded_gp_params_from_jax",
    "svgp_params_from_jax",
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
    """A :class:`BatchedGPParams` from the JAX ``GPParams`` leaves as numpy
    arrays, each ``(M,)`` (or ``(M, C)`` on the gridded surface)."""
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


def gridded_gp_params_from_jax(
    params, device: torch.device | str, dtype: torch.dtype
) -> BatchedGPParams:
    """The gridded hyperparameters: a :class:`BatchedGPParams` with ``(M, C)``
    leaves from a JAX ``GPParams`` (or any object with ``raw_lengthscale``
    and ``raw_variance``) with leading ``(M, C)`` dims, as
    ``gridded_ensemble_step(return_fit=True)`` and ``coarse_warm_start``
    return them; the port's ``gp_init`` and ``refined_gridded_f64`` take it."""
    ls, var = np.asarray(params.raw_lengthscale), np.asarray(params.raw_variance)
    if ls.ndim != 2 or ls.shape != var.shape:
        raise ValueError(f"expected two (M, C) leaves, got {ls.shape} and {var.shape}")
    return gp_params_from_jax(ls, var, device, dtype)


def svgp_params_from_jax(
    params: tp.Mapping[str, np.ndarray], device: torch.device | str, dtype: torch.dtype
) -> dict[str, torch.Tensor]:
    """The port's SVGP parameter dict from the JAX one (``ops/svgp.py``'s
    ``raw_ls``, ``raw_var``, ``z``, ``m``, ``ls_flat``), as tensors on
    ``device`` in ``dtype``."""
    return {k: torch.tensor(np.array(v), dtype=dtype, device=device) for k, v in params.items()}


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
