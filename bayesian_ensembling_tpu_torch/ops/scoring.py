"""Probabilistic scoring: the closed-form Gaussian CRPS.

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/scoring.py``,
main-path subset.
"""

from __future__ import annotations

import torch

__all__ = ["gaussian_crps", "mean_gaussian_crps"]

_INV_SQRT_PI = 0.5641895835477563  # 1/sqrt(pi)
_INV_SQRT_2PI = 0.3989422804014327  # 1/sqrt(2*pi)
_INV_SQRT_2 = 0.7071067811865476  # 1/sqrt(2)


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
