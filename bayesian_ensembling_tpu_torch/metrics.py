"""Validation metrics: NLL, RMSE, CRPS, Gaussian W2 between posteriors.

PyTorch counterpart of ``bayesian_ensembling_tpu/metrics.py``: the scoring
trio of the reference's perfect-model tests plus CRPS, as functions of a
:class:`~bayesian_ensembling_tpu_torch.data.Posterior` that return floats.
NLL uses the correct stddev (the reference evaluates it under an effective
stddev of sigma^2).  Each runs on the device the posterior's moments are on.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_ensembling_tpu_torch.data import Posterior
from bayesian_ensembling_tpu_torch.ops.distributions import FullCovGaussian
from bayesian_ensembling_tpu_torch.ops.scoring import diag_log_likelihood, mean_gaussian_crps
from bayesian_ensembling_tpu_torch.ops.wasserstein import (
    gaussian_w2_distance,
    gaussian_w2_distance_diag,
)

__all__ = ["nll", "rmse", "w2_between_posteriors", "crps"]


def _flat_obs(post: Posterior, obs_values: np.ndarray) -> torch.Tensor:
    mean = post.gaussian.mean
    flat = np.asarray(obs_values).reshape(obs_values.shape[0], -1)
    return torch.as_tensor(flat, dtype=mean.dtype, device=mean.device)


def nll(post: Posterior, obs_values: np.ndarray) -> float:
    """Mean negative log-likelihood of observations under the posterior
    marginals."""
    ll = diag_log_likelihood(post.gaussian.mean, post.gaussian.variance,
                             _flat_obs(post, obs_values))
    return float(-torch.mean(ll))


def rmse(post: Posterior, obs_values: np.ndarray) -> float:
    """Across-realisation RMSE of the posterior mean, time-averaged."""
    err = post.gaussian.mean - _flat_obs(post, obs_values)
    return float(torch.mean(torch.sqrt(torch.mean(err * err, dim=0))))


def crps(post: Posterior, obs_values: np.ndarray) -> float:
    """Mean continuous ranked probability score of the posterior marginals
    against observation realisations (closed-form Gaussian CRPS): a strictly
    proper score of the full predictive distribution against held-out
    trajectories."""
    sigma = torch.sqrt(post.gaussian.variance)
    return float(torch.mean(mean_gaussian_crps(post.gaussian.mean, sigma,
                                               _flat_obs(post, obs_values))))


def w2_between_posteriors(a: Posterior, b: Posterior) -> float:
    """Gaussian W2 between two posteriors: full-covariance when either
    carries one, else the diagonal form."""
    ga, gb = a.gaussian, b.gaussian
    a_full = isinstance(ga, FullCovGaussian)
    b_full = isinstance(gb, FullCovGaussian)
    if a_full or b_full:
        cov_a = ga.cov if a_full else torch.diag(ga.variance)
        cov_b = gb.cov if b_full else torch.diag(gb.variance)
        return float(gaussian_w2_distance(ga.mean, cov_a, gb.mean, cov_b))
    return float(gaussian_w2_distance_diag(ga.mean, ga.variance, gb.mean, gb.variance))
