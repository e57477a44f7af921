"""The port's Gaussian moment containers and the full-covariance
log-likelihood against the JAX package, in float64.

Tolerance: the same closed forms on both sides; the full-covariance
densities factor the same well-conditioned covariance with different
backward-stable solvers, so everything agrees to 1e-10 (relative to the
largest entry).  Samples are not compared draw for draw (the JAX random
stream is not reproduced): their moments over 40,000 draws are held to the
distribution's within 0.05, several standard errors.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import distributions as jd
from bayesian_ensembling_tpu.ops import scoring as jscoring
from bayesian_ensembling_tpu_torch.ops import distributions as td
from bayesian_ensembling_tpu_torch.ops import scoring as tscoring

torch.set_num_threads(1)

TOL = 1e-10


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def make_cov(rng, n):
    x = np.sort(rng.normal(size=n))
    d = np.abs(x[:, None] - x[None, :])
    return (1.0 + np.sqrt(3.0) * d) * np.exp(-np.sqrt(3.0) * d) + np.diag(rng.uniform(0.05, 0.2, n))


@pytest.mark.parametrize("shape", [(7,), (3, 7)])
def test_diag_gaussian_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    mean, var = rng.normal(size=shape), rng.uniform(0.1, 2.0, size=shape)
    x = rng.normal(size=(5,) + shape)
    want = jd.DiagGaussian(jnp.asarray(mean), jnp.asarray(var))
    got = td.DiagGaussian(torch.from_numpy(mean), torch.from_numpy(var))
    close(got.variance, want.variance)
    close(got.stddev, want.stddev)
    close(got.log_prob(torch.from_numpy(x)), want.log_prob(jnp.asarray(x)))


@pytest.mark.parametrize("n", [1, 9, 20])
def test_full_cov_gaussian_matches_jax(n):
    rng = np.random.default_rng(n)
    mean, cov = rng.normal(size=n), make_cov(rng, n)
    want = jd.FullCovGaussian(jnp.asarray(mean), jnp.asarray(cov))
    got = td.FullCovGaussian(torch.from_numpy(mean), torch.from_numpy(cov))
    close(got.variance, want.variance)
    close(got.stddev, want.stddev)
    close(got.chol(), want.chol())
    close(got.chol(jitter=1e-3), want.chol(jitter=1e-3))
    one = rng.normal(size=n)
    many = rng.normal(size=(6, n))
    grid = rng.normal(size=(2, 3, n))
    close(got.log_prob(torch.from_numpy(one)), want.log_prob(jnp.asarray(one)))
    close(got.log_prob(torch.from_numpy(many)), jax.vmap(want.log_prob)(jnp.asarray(many)))
    close(got.log_prob(torch.from_numpy(grid)), jax.vmap(jax.vmap(want.log_prob))(jnp.asarray(grid)))


def test_sample_moments():
    rng = np.random.default_rng(3)
    n = 5
    mean, cov = rng.normal(size=n), make_cov(rng, n)
    gen = torch.Generator().manual_seed(11)
    full = td.FullCovGaussian(torch.from_numpy(mean), torch.from_numpy(cov))
    draws = full.sample(gen, (40000,))
    assert draws.shape == (40000, n) and draws.dtype == torch.float64
    np.testing.assert_allclose(draws.mean(dim=0).numpy(), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(draws.numpy().T), cov, atol=0.05)
    assert full.sample(gen).shape == (n,)
    diag = td.DiagGaussian(torch.from_numpy(mean), torch.from_numpy(np.diag(cov).copy()))
    draws = diag.sample(gen, (40000,))
    np.testing.assert_allclose(draws.mean(dim=0).numpy(), mean, atol=0.05)
    np.testing.assert_allclose(draws.var(dim=0).numpy(), np.diag(cov), atol=0.05)
    # The same generator state gives the same draw.
    a = full.sample(torch.Generator().manual_seed(5))
    b = full.sample(torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


@pytest.mark.parametrize("m,t,r", [(3, 12, 6), (1, 17, 4)])
def test_fullcov_constant_vector_log_likelihood_matches_jax(m, t, r):
    """Batched over the models in the port, one model at a time in JAX."""
    rng = np.random.default_rng(m * t)
    means = rng.normal(size=(m, t))
    chols = np.stack([np.linalg.cholesky(make_cov(rng, t)) for _ in range(m)])
    obs = rng.normal(size=(r, t))
    got = tscoring.fullcov_constant_vector_log_likelihood(
        torch.from_numpy(means), torch.from_numpy(chols), torch.from_numpy(obs))
    assert got.shape == (m, r, t)
    for i in range(m):
        want = jscoring.fullcov_constant_vector_log_likelihood(
            jnp.asarray(means[i]), jnp.asarray(chols[i]), jnp.asarray(obs))
        close(got[i], want)
    single = tscoring.fullcov_constant_vector_log_likelihood(
        torch.from_numpy(means[0]), torch.from_numpy(chols[0]), torch.from_numpy(obs))
    assert torch.equal(single, got[0])
    # What it abbreviates: the density of the constant vector obs_t * 1.
    g = td.FullCovGaussian(torch.from_numpy(means[0]), torch.from_numpy(chols[0] @ chols[0].T))
    direct = g.log_prob(torch.from_numpy(obs)[:, :, None] * torch.ones(t, dtype=torch.float64))
    close(got[0], direct.numpy(), tol=1e-8)  # cov + 1e-10 I on this side
