"""CRPS weights and the Wasserstein-2 barycentre, written from their definitions.

A model's raw score at a time step is 1 / (its Gaussian CRPS averaged over
the observation members), with the closed form

    CRPS(N(mu, s^2), o) = s (z (2 Phi(z) - 1) + 2 phi(z) - 1/sqrt(pi)),  z = (o - mu) / s.

Padded models score 0.  The scores are normalised to sum to one over the
models at each time step and averaged over time, which gives one weight a
model.  The barycentre of the models' Gaussian marginals under W2 is the
weighted mean of their means and the weighted mean of their standard
deviations, point by point.
"""

from __future__ import annotations

import math

import torch


def crps(mu: torch.Tensor, sd: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Mean CRPS ``(..., T)`` of Gaussians ``(..., T)`` against the members
    ``(R_obs, T)``."""
    z = (obs - mu[..., None, :]) / sd[..., None, :]
    cdf = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    score = sd[..., None, :] * (z * (2.0 * cdf - 1.0) + 2.0 * pdf - 1.0 / math.sqrt(math.pi))
    return torch.mean(score, dim=-2)


def weights(hist_mean, hist_var, obs, model_mask):
    """Weights ``(M, ...)`` of ``M`` models from their historical marginals
    ``(M, ..., T)`` against the members ``obs`` ``(..., R_obs, T)`` (one
    set a problem, such as a grid cell, or one for all); ``model_mask``
    ``(M, ...)`` is 1 for a real model and 0 for padding."""
    floor = math.sqrt(torch.finfo(hist_mean.dtype).tiny)
    raw = torch.stack([1.0 / torch.clamp(crps(mean, torch.sqrt(var), obs), min=floor)
                       for mean, var in zip(hist_mean, hist_var)])  # a model at a time
    raw = raw * model_mask[..., None]
    return torch.mean(raw / torch.sum(raw, dim=0, keepdim=True), dim=-1)


def barycentre(w, mean, var):
    """W2 barycentre (mean, std) ``(..., T)`` of ``M`` Gaussians
    ``(M, ..., T)`` weighted by ``w`` ``(M, ...)``."""
    return (torch.sum(w[..., None] * mean, dim=0),
            torch.sum(w[..., None] * torch.sqrt(var), dim=0))
