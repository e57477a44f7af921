"""Gaussian Wasserstein-2 geometry: matrix sqrt, W2 distance, barycentres.

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/wasserstein.py``.
Where the JAX functions are vmapped over pairs or points, these take any
leading batch shape.  The pointwise barycentre
(:func:`batched_gaussian_barycentre`) is the one implementation behind both
``schemes.Barycentre`` and the fused step's tail.
"""

from __future__ import annotations

import typing as tp

import torch

__all__ = [
    "SIGMA_MODES",
    "sqrtm_psd",
    "bures_covariance_distance",
    "gaussian_w2_distance",
    "gaussian_w2_distance_diag",
    "gaussian_barycentre_1d",
    "gaussian_barycentre_1d_fixed_point",
    "batched_gaussian_barycentre",
]

#: Valid ``sigma_mode`` values for the pointwise Gaussian combination.
SIGMA_MODES = ("w2", "compat", "mixture")


def _trace(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1)


def sqrtm_psd(a: torch.Tensor) -> torch.Tensor:
    """Matrix square root of symmetric PSD matrices ``(..., N, N)`` via
    ``eigh``, eigenvalues clamped at zero so that the numerically negative
    ones of a near-singular covariance cannot produce NaN."""
    w, v = torch.linalg.eigh(a)
    w = torch.clamp(w, min=0.0)
    return (v * torch.sqrt(w)[..., None, :]) @ v.mT


def bures_covariance_distance(cov_a: torch.Tensor, cov_b: torch.Tensor) -> torch.Tensor:
    """Bures metric between covariance matrices, means ignored:
    ``tr(A) + tr(B) - 2 tr((A^1/2 B A^1/2)^1/2)``."""
    root_a = sqrtm_psd(cov_a)
    cross = sqrtm_psd(root_a @ cov_b @ root_a)
    return _trace(cov_a) + _trace(cov_b) - 2.0 * _trace(cross)


def _location_gap(mu1, mu2, squared_mean_gap):
    gap = torch.linalg.vector_norm(mu1 - mu2, dim=-1)
    return torch.square(gap) if squared_mean_gap else gap


def gaussian_w2_distance(
    mu1: torch.Tensor,
    cov1: torch.Tensor,
    mu2: torch.Tensor,
    cov2: torch.Tensor,
    *,
    squared_mean_gap: bool = False,
) -> torch.Tensor:
    """W2 "distance" between full-covariance Gaussians, ``(..., N)`` means
    and ``(..., N, N)`` covariances, broadcast over the leading shape.

    With ``squared_mean_gap=True`` this is the textbook squared
    Wasserstein-2 distance ``|mu1-mu2|^2 + tr(cov1 + cov2 - 2 (cov1^1/2 cov2
    cov1^1/2)^1/2)``.  The default reproduces the reference, which uses the
    plain L2 norm of the mean gap.
    """
    return _location_gap(mu1, mu2, squared_mean_gap) + bures_covariance_distance(cov1, cov2)


def gaussian_w2_distance_diag(
    mu1: torch.Tensor,
    var1: torch.Tensor,
    mu2: torch.Tensor,
    var2: torch.Tensor,
    *,
    squared_mean_gap: bool = False,
) -> torch.Tensor:
    """W2 distance between diagonal Gaussians: the Bures term collapses to
    ``sum (sqrt(var1) - sqrt(var2))^2``."""
    s1 = torch.sqrt(torch.clamp(var1, min=0.0))
    s2 = torch.sqrt(torch.clamp(var2, min=0.0))
    return _location_gap(mu1, mu2, squared_mean_gap) + torch.sum(torch.square(s1 - s2), dim=-1)


def gaussian_barycentre_1d(
    means: torch.Tensor,
    std_devs: torch.Tensor,
    weights: torch.Tensor,
    mask: tp.Optional[torch.Tensor] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form W2 barycentre of 1-D Gaussians ``(M,)``: for weights
    summing to one it is ``N(sum w_i m_i, (sum w_i s_i)^2)``.  ``mask``
    zeroes out padded ensemble members."""
    if mask is not None:
        weights = weights * mask
    return torch.sum(weights * means), torch.sum(weights * std_devs)


def gaussian_barycentre_1d_fixed_point(
    means: torch.Tensor,
    std_devs: torch.Tensor,
    weights: torch.Tensor,
    tolerance: float = 1e-6,
    init_var: float = 1.0,
    max_iters: int = 200,
    return_iters: bool = False,
):
    """Reference-faithful fixed-point barycentre (parity/compat path).

    Iterates ``v <- sqrt(v) * sum_i w_i s_i`` from ``init_var`` with the
    reference's *signed* convergence test ``candidate - current < tol`` (so
    an iteration that decreases the variance terminates at once) and its
    200-iteration cap.  The member axis is ``-2`` when the inputs have a
    point axis (``(..., M, N)``: all points advance in one batched loop,
    each stopping on its own test) and the only axis for ``(M,)`` inputs.

    Returns ``(mu, sigma)``, plus each point's iteration count (int64) when
    ``return_iters``; a point that hit the cap reports ``max_iters + 1``.
    """
    dim = -2 if means.dim() > 1 else 0
    weighted_std_sum = torch.sum(weights * std_devs, dim=dim)
    var = torch.full_like(weighted_std_sum, init_var)
    n_iters = torch.zeros(var.shape, dtype=torch.int64, device=var.device)
    done = torch.zeros(var.shape, dtype=torch.bool, device=var.device)
    while True:
        active = ~done & (n_iters <= max_iters)
        if not bool(active.any()):
            break
        candidate = torch.sqrt(var) * weighted_std_sum
        done = torch.where(active, (candidate - var) < tolerance, done)
        var = torch.where(active, candidate, var)
        n_iters = n_iters + active
    mu = torch.sum(weights * means, dim=dim)
    if return_iters:
        return mu, torch.sqrt(var), n_iters
    return mu, torch.sqrt(var)


def batched_gaussian_barycentre(
    means: torch.Tensor,
    std_devs: torch.Tensor,
    weights: torch.Tensor,
    mask: tp.Optional[torch.Tensor] = None,
    *,
    compat_fixed_point: bool = False,
    sigma_mode: str = "w2",
) -> tp.Tuple[torch.Tensor, ...]:
    """Barycentre over the model axis for every point at once.

    Args:
      means / std_devs: ``(..., n_models, n_points)``.
      weights: the same shape, or broadcastable to it (``(..., n_models,
        1)`` for one weight per model).
      mask: optional validity mask for padded models, like ``weights``.
      compat_fixed_point: deprecated alias for ``sigma_mode="compat"``.
      sigma_mode: how the combined sigma is formed (the mean is
        ``sum w_i mu_i`` in every mode):
          * ``"w2"``: closed-form W2 barycentre ``sigma = sum w_i sigma_i``
            (the exact fixed point of the reference's iteration);
          * ``"compat"``: the reference-faithful fixed-point iteration
            including its signed convergence test, which exits after one
            step whenever ``sum w_i sigma_i < 1`` and returns
            ``sqrt(sum w_i sigma_i)``;
          * ``"mixture"``: moment-matched Gaussian mixture,
            ``sigma^2 = sum w_i (sigma_i^2 + (mu_i - mu)^2)``.

    Returns:
      ``(mu, sigma)`` of shape ``(..., n_points)``, or in compat mode
      ``(mu, sigma, n_iters)`` with each point's iteration count (callers
      use it for the non-convergence warning).
    """
    if compat_fixed_point:
        sigma_mode = "compat"
    if sigma_mode not in SIGMA_MODES:
        raise ValueError(f"sigma_mode {sigma_mode!r} not in {SIGMA_MODES}")
    if mask is not None:
        weights = weights * mask
    if sigma_mode == "compat":
        return gaussian_barycentre_1d_fixed_point(
            means, std_devs, weights.expand_as(means), return_iters=True
        )
    mu = torch.sum(weights * means, dim=-2)
    if sigma_mode == "mixture":
        dev = means - mu[..., None, :]
        return mu, torch.sqrt(torch.sum(weights * (torch.square(std_devs) + dev * dev), dim=-2))
    return mu, torch.sum(weights * std_devs, dim=-2)
