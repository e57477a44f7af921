"""Probabilistic scoring: Gaussian log-likelihood, closed-form CRPS and the
IMQ kernel Stein discrepancy of 1-D marginals.

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/scoring.py`` (the
full-covariance log-likelihood goes with the library API, ROADMAP A7).
Where the JAX functions are vmapped over points or models, these take any
leading batch shape.
"""

from __future__ import annotations

import torch

__all__ = [
    "diag_log_likelihood",
    "gaussian_crps",
    "mean_gaussian_crps",
    "imq_k0_matrix",
    "imq_ksd_1d",
    "batched_imq_ksd",
]

_LOG_2PI = 1.8378770664093453
_INV_SQRT_PI = 0.5641895835477563  # 1/sqrt(pi)
_INV_SQRT_2PI = 0.3989422804014327  # 1/sqrt(2*pi)
_INV_SQRT_2 = 0.7071067811865476  # 1/sqrt(2)


def diag_log_likelihood(mean: torch.Tensor, var: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Per-point Gaussian log-density of ``obs`` under ``N(mean, var)``,
    elementwise with broadcasting: ``(n_points,)`` marginals against
    ``(n_obs_real, n_points)`` observations give ``(n_obs_real, n_points)``
    (the diag branch of the reference's LogLikelihoodWeight)."""
    z2 = torch.square(obs - mean) / var
    return -0.5 * (z2 + torch.log(var) + _LOG_2PI)


def gaussian_crps(obs: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Closed-form CRPS of a Gaussian forecast, elementwise:
    ``sigma * (z (2 Phi(z) - 1) + 2 phi(z) - 1/sqrt(pi))``, ``z = (obs - mu)/sigma``."""
    z = (obs - mu) / sigma
    cdf = 0.5 * (1.0 + torch.erf(z * _INV_SQRT_2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * (z * z))
    return sigma * (z * (2.0 * cdf - 1.0) + 2.0 * pdf - _INV_SQRT_PI)


def mean_gaussian_crps(mean: torch.Tensor, sigma: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """CRPS averaged over observation realisations.

    Args:
      mean, sigma: ``(..., n_points)`` posterior marginal mean / stddev, any
        leading batch shape.
      obs: ``(n_obs_real, n_points)``.

    Returns:
      ``(..., n_points)`` mean CRPS.
    """
    return torch.mean(gaussian_crps(obs, mean[..., None, :], sigma[..., None, :]), dim=-2)


def imq_k0_matrix(
    samples: torch.Tensor, grads: torch.Tensor, c: float = 1.0, beta: float = -0.5
) -> torch.Tensor:
    """The IMQ Stein kernel matrix of 1-D samples (reference ``k_0_fun``,
    dim = 1), ``(..., n) -> (..., n, n)``; ``samples`` broadcasts against
    ``grads``::

      k0(x, y) = g_x g_y K + 2 beta (g_y - g_x) d K' - 2 beta K'
                 - 4 beta (beta-1) d^2 K''

    with d = x - y, K = (c^2 + d^2)^beta.
    """
    d = samples[..., :, None] - samples[..., None, :]
    imq = c**2 + torch.square(d)
    gg = grads[..., :, None] * grads[..., None, :]
    term1 = gg * imq**beta
    term2 = -2.0 * beta * grads[..., :, None] * d * imq ** (beta - 1.0)
    term3 = 2.0 * beta * grads[..., None, :] * d * imq ** (beta - 1.0)
    term4 = -2.0 * beta * imq ** (beta - 1.0)  # dim = 1
    term5 = -4.0 * beta * (beta - 1.0) * imq ** (beta - 2.0) * torch.square(d)
    return term1 + term2 + term3 + term4 + term5


def imq_ksd_1d(samples: torch.Tensor, grads: torch.Tensor, c: float = 1.0,
               beta: float = -0.5) -> torch.Tensor:
    """Kernel Stein discrepancy with an IMQ Stein kernel, 1-D marginals:
    ``sqrt(sum_jk k0) / n`` over the last axis (``(..., n) -> (...)``)."""
    total = torch.sum(imq_k0_matrix(samples, grads, c=c, beta=beta), dim=(-2, -1))
    return torch.sqrt(total) / samples.shape[-1]


def batched_imq_ksd(
    mean: torch.Tensor,
    scale: torch.Tensor,
    obs: torch.Tensor,
    c: float = 1.0,
    beta: float = -0.5,
) -> torch.Tensor:
    """KSD of Gaussian marginals against observation samples, all points at
    once.

    The score is ``d/dx log N(x; mu, scale) = -(x - mu) / scale^2``.  The
    reference passes the *variance* where its distribution expects a scale;
    the caller keeps that quirk by choosing ``scale``.

    Args:
      mean, scale: ``(..., n_points)`` marginal location and scale.
      obs: ``(n_obs_real, n_points)`` observation samples.

    Returns:
      ``(..., n_points)`` KSD values.  Materialises ``(..., n_points,
      n_obs_real, n_obs_real)`` temporaries.
    """
    x = obs.T  # (n_points, n)
    grads = -(x - mean[..., None]) / torch.square(scale[..., None])
    return imq_ksd_1d(x, grads, c=c, beta=beta)
