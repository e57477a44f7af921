"""Gaussian moment containers.

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/distributions.py``:
plain dataclasses that keep the moments as tensors, so every consumer
(weights, barycentres, metrics) is a function of tensors on the device the
moments are on.  Sampling takes a ``torch.Generator`` on that device; the
JAX package's random stream is not reproduced.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from bayesian_ensembling_tpu_torch.ops import linalg_cuda

__all__ = ["DiagGaussian", "FullCovGaussian", "GaussianMoments"]

_LOG_2PI = 1.8378770664093453  # log(2*pi)


def _standard_normal(like: torch.Tensor, shape, generator: tp.Optional[torch.Generator]):
    return torch.randn(tuple(shape), generator=generator, dtype=like.dtype, device=like.device)


@dataclasses.dataclass
class DiagGaussian:
    """Independent Gaussians over N points: ``N(mean_i, var_i)`` per point."""

    mean: torch.Tensor  # (..., N)
    var: torch.Tensor  # (..., N)

    @property
    def variance(self) -> torch.Tensor:
        return self.var

    @property
    def stddev(self) -> torch.Tensor:
        return torch.sqrt(self.var)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise Gaussian log-density, shape = broadcast(x, mean)."""
        z2 = torch.square(x - self.mean) / self.var
        return -0.5 * (z2 + torch.log(self.var) + _LOG_2PI)

    def sample(
        self, generator: tp.Optional[torch.Generator] = None, sample_shape: tp.Tuple[int, ...] = ()
    ) -> torch.Tensor:
        eps = _standard_normal(self.mean, tuple(sample_shape) + self.mean.shape, generator)
        return self.mean + eps * torch.sqrt(self.var)


@dataclasses.dataclass
class FullCovGaussian:
    """A single N-dimensional Gaussian with full covariance.  The Cholesky
    factor is computed on demand and jittered for PSD safety."""

    mean: torch.Tensor  # (N,)
    cov: torch.Tensor  # (N, N)

    @property
    def variance(self) -> torch.Tensor:
        return torch.diagonal(self.cov, dim1=-2, dim2=-1)

    @property
    def stddev(self) -> torch.Tensor:
        return torch.sqrt(self.variance)

    def chol(self, jitter: float = 1e-10) -> torch.Tensor:
        """Lower factor of ``cov + jitter I``: the Cholesky kernel on the
        card within its size cap, torch.linalg beyond and on the CPU."""
        n = self.cov.shape[-1]
        eye = torch.eye(n, dtype=self.cov.dtype, device=self.cov.device)
        return linalg_cuda.chol_routed((self.cov + jitter * eye)[None].contiguous())[0]

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Joint log-density of the N-dimensional vector(s) ``x`` ``(..., N)``.

        One vector goes through the vector-solve kernel's forward pass (z
        and the log-determinant in one launch); many vectors are a
        triangular solve with a matrix right-hand side, left to
        ``torch.linalg``.
        """
        n = self.mean.shape[-1]
        chol = self.chol()
        diff = x - self.mean
        if diff.dim() == 1:
            z, logdet = linalg_cuda.solve_vec_forward(chol[None].contiguous(), diff[None].contiguous())
            z, logdet = z[0], logdet[0]
        else:
            flat = diff.reshape(-1, n)
            z = torch.linalg.solve_triangular(chol, flat.T, upper=False).T.reshape(diff.shape)
            logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        return -0.5 * (torch.sum(torch.square(z), dim=-1) + logdet + n * _LOG_2PI)

    def sample(
        self, generator: tp.Optional[torch.Generator] = None, sample_shape: tp.Tuple[int, ...] = ()
    ) -> torch.Tensor:
        eps = _standard_normal(self.mean, tuple(sample_shape) + self.mean.shape, generator)
        return self.mean + eps @ self.chol().T


GaussianMoments = tp.Union[DiagGaussian, FullCovGaussian]
