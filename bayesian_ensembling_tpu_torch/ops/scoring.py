"""Probabilistic scoring: Gaussian log-likelihood, closed-form CRPS and the
IMQ kernel Stein discrepancy of 1-D marginals.

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/scoring.py``.
Where the JAX functions are vmapped over points or models, these take any
leading batch shape.
"""

from __future__ import annotations

import torch

from bayesian_ensembling_tpu_torch.ops import linalg_cuda

__all__ = [
    "diag_log_likelihood",
    "fullcov_constant_vector_log_likelihood",
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


def fullcov_constant_vector_log_likelihood(
    mean: torch.Tensor, chol: torch.Tensor, obs: torch.Tensor
) -> torch.Tensor:
    """Reference-semantics MVN log-likelihood for full-covariance
    posteriors, every model of a collection at once.

    The reference feeds ``obs[:, None]`` (shape ``(T, 1)``) into an MVN over
    T dims; broadcasting turns row ``t`` into the *constant vector*
    ``obs_t * ones(T)``, so the per-time score is ``log N(obs_t * 1; mu,
    Sigma)``.  With ``a = L^-1 1`` and ``b = L^-1 mu`` this is, for all t::

      ll_t = -0.5 * (|obs_t a - b|^2 + logdet Sigma + T log 2pi).

    ``a``, ``b`` and the log-determinant come from two calls of
    :func:`~bayesian_ensembling_tpu_torch.ops.linalg_cuda.solve_vec_forward`
    (the vector-solve kernel's forward pass on the card), batched over the
    models.

    Args:
      mean: ``(M, T)`` posterior means (or ``(T,)`` for one model).
      chol: ``(M, T, T)`` lower Cholesky factors of the posterior
        covariances (or ``(T, T)``).
      obs: ``(n_obs_real, T)`` observations.

    Returns:
      ``(M, n_obs_real, T)`` log-densities (``(n_obs_real, T)`` for one
      model).
    """
    single = mean.dim() == 1
    if single:
        mean, chol = mean[None], chol[None]
    t = mean.shape[-1]
    chol = chol.contiguous()
    a, logdet = linalg_cuda.solve_vec_forward(chol, torch.ones_like(mean))
    b, _ = linalg_cuda.solve_vec_forward(chol, mean.contiguous())
    # |obs_t * a - b|^2 = obs_t^2 |a|^2 - 2 obs_t a.b + |b|^2
    aa = torch.sum(a * a, dim=-1)[:, None, None]
    ab = torch.sum(a * b, dim=-1)[:, None, None]
    bb = torch.sum(b * b, dim=-1)[:, None, None]
    quad = torch.square(obs) * aa - 2.0 * obs * ab + bb
    ll = -0.5 * (quad + logdet[:, None, None] + t * _LOG_2PI)
    return ll[0] if single else ll


def gaussian_crps(obs: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Closed-form CRPS of a Gaussian forecast, elementwise:
    ``sigma * (z (2 Phi(z) - 1) + 2 phi(z) - 1/sqrt(pi))``, ``z = (obs - mu)/sigma``.

    Computed in place in two buffers of the output's size, each operation
    the one of that formula term by term, so the values are the
    expression's bit for bit: the gridded tail's ``(M, C, R_obs, T)``
    batch takes 2.66 GiB a buffer, and the expression held six.  Not
    differentiable (the buffers are overwritten): inputs that require grad
    with grad mode on raise a ``ValueError``."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (obs, mu, sigma)):
        raise ValueError("gaussian_crps works in place and has no gradient; call it on "
                         "tensors that do not require grad, or under torch.no_grad()")
    z = (obs - mu) / sigma
    out = (z * _INV_SQRT_2).erf_().add_(1.0).mul_(0.5)  # Phi(z)
    out.mul_(2.0).sub_(1.0).mul_(z)  # z (2 Phi(z) - 1)
    pdf = z.mul_(z).mul_(-0.5).exp_().mul_(_INV_SQRT_2PI)  # phi(z), in z's buffer
    return out.add_(pdf.mul_(2.0)).sub_(_INV_SQRT_PI).mul_(sigma)


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
