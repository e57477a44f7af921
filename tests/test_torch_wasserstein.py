"""The port's Gaussian Wasserstein-2 geometry against the JAX package, in
float64.

Tolerance: closed forms agree to 1e-10.  ``sqrtm_psd`` takes an
eigendecomposition on both sides (LAPACK both here, but through different
routines); on a near-singular matrix its clamped square roots of eigenvalues
near 1e-16 differ by up to 1e-8, so that case and the Bures terms built on
it are held to 1e-8.  The compat fixed point is the same scalar recurrence,
so sigma agrees to 1e-10 and the iteration counts exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import wasserstein as jws
from bayesian_ensembling_tpu_torch.ops import wasserstein as tws

torch.set_num_threads(1)

TOL = 1e-10


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def make_cov(rng, n, rank=None):
    a = rng.normal(size=(n, rank or n))
    return a @ a.T / n + (0.0 if rank else 0.1) * np.eye(n)


def test_sqrtm_psd_matches_jax():
    rng = np.random.default_rng(0)
    a = make_cov(rng, 9)
    close(tws.sqrtm_psd(torch.from_numpy(a)), jws.sqrtm_psd(jnp.asarray(a)))
    root = tws.sqrtm_psd(torch.from_numpy(a))
    close(root @ root, a)
    batch = np.stack([make_cov(rng, 6) for _ in range(4)])
    close(tws.sqrtm_psd(torch.from_numpy(batch)), jax.vmap(jws.sqrtm_psd)(jnp.asarray(batch)))


def test_sqrtm_psd_near_singular():
    rng = np.random.default_rng(1)
    a = make_cov(rng, 8, rank=3)  # five eigenvalues at round-off, some negative
    got = tws.sqrtm_psd(torch.from_numpy(a))
    assert torch.isfinite(got).all()
    close(got, jws.sqrtm_psd(jnp.asarray(a)), tol=1e-8)
    close(got @ got, a, tol=1e-8)


@pytest.mark.parametrize("squared", [False, True])
def test_w2_distances_match_jax(squared):
    rng = np.random.default_rng(2)
    n = 7
    mu1, mu2 = rng.normal(size=n), rng.normal(size=n)
    c1, c2 = make_cov(rng, n), make_cov(rng, n)
    v1, v2 = rng.uniform(0.1, 2.0, n), rng.uniform(0.1, 2.0, n)
    t = torch.from_numpy
    close(tws.bures_covariance_distance(t(c1), t(c2)),
          jws.bures_covariance_distance(jnp.asarray(c1), jnp.asarray(c2)), tol=1e-8)
    close(tws.gaussian_w2_distance(t(mu1), t(c1), t(mu2), t(c2), squared_mean_gap=squared),
          jws.gaussian_w2_distance(*(jnp.asarray(a) for a in (mu1, c1, mu2, c2)),
                                   squared_mean_gap=squared), tol=1e-8)
    close(tws.gaussian_w2_distance_diag(t(mu1), t(v1), t(mu2), t(v2), squared_mean_gap=squared),
          jws.gaussian_w2_distance_diag(*(jnp.asarray(a) for a in (mu1, v1, mu2, v2)),
                                        squared_mean_gap=squared))
    # The un-squared mean gap is the default (the reference's quirk).
    assert squared or float(tws.gaussian_w2_distance_diag(t(mu1), t(v1), t(mu2), t(v1))) == \
        pytest.approx(np.linalg.norm(mu1 - mu2), abs=1e-12)


def test_pairwise_w2_by_broadcasting_matches_vmapped_jax():
    """What ModelSimilarityWeight's single mode computes: all (i, j) pairs."""
    rng = np.random.default_rng(3)
    m, n = 4, 6
    means = rng.normal(size=(m, n))
    covs = np.stack([make_cov(rng, n) for _ in range(m)])
    want = jax.vmap(jax.vmap(jws.gaussian_w2_distance, in_axes=(None, None, 0, 0)),
                    in_axes=(0, 0, None, None))(*(jnp.asarray(a) for a in (means, covs, means, covs)))
    mt, ct = torch.from_numpy(means), torch.from_numpy(covs)
    got = tws.gaussian_w2_distance(mt[:, None], ct[:, None], mt[None], ct[None])
    close(got, want, tol=1e-7)  # the zero diagonal is sqrt of round-off on both sides


def test_barycentre_1d_matches_jax():
    rng = np.random.default_rng(4)
    means, stds = rng.normal(size=5), rng.uniform(0.2, 1.5, 5)
    w = rng.uniform(size=5)
    w /= w.sum()
    mask = np.array([1.0, 1.0, 0.0, 1.0, 1.0])
    t = torch.from_numpy
    for mk in (None, mask):
        got = tws.gaussian_barycentre_1d(t(means), t(stds), t(w), None if mk is None else t(mk))
        want = jws.gaussian_barycentre_1d(jnp.asarray(means), jnp.asarray(stds), jnp.asarray(w),
                                          None if mk is None else jnp.asarray(mk))
        close(got[0], want[0])
        close(got[1], want[1])


def fixed_point_case():
    """(M=3, N=5) points: sum w sigma < 1 (exits after one step), a slowly
    converging one, sum w sigma > 1 (converges upward), sum w sigma == 1
    exactly (candidate == var: done at once) and a NaN sigma (never passes
    the test: runs into the cap)."""
    means = np.arange(15.0).reshape(3, 5) / 10.0
    w = np.full((3, 5), 1.0 / 3.0)
    stds = np.stack([np.array([0.3, 1.9, 1.2, 1.0, np.nan])] * 3)
    return means, stds, w


def test_fixed_point_sigma_and_iteration_counts_match_jax():
    means, stds, w = fixed_point_case()
    t = torch.from_numpy
    mu, sigma, iters = tws.batched_gaussian_barycentre(t(means), t(stds), t(w), sigma_mode="compat")
    wmu, wsigma, witers = jws.batched_gaussian_barycentre(
        jnp.asarray(means), jnp.asarray(stds), jnp.asarray(w), sigma_mode="compat")
    close(mu, wmu)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(wsigma), rtol=0, atol=TOL, equal_nan=True)
    assert iters.dtype == torch.int64
    np.testing.assert_array_equal(iters.numpy(), np.asarray(witers))
    assert iters[0] == 1 and iters[3] == 1  # signed test: a non-increasing step ends it
    assert iters[4] == 201  # the cap
    assert 1 < iters[1] <= 201 and 1 < iters[2] <= 201
    close(sigma[0], np.sqrt(0.3))  # exits after one step at sqrt(sum w sigma)
    # The scalar form is the batch of one.
    for j in range(5):
        one = tws.gaussian_barycentre_1d_fixed_point(t(means[:, j].copy()), t(stds[:, j].copy()),
                                                     t(w[:, j].copy()), return_iters=True)
        want = jws.gaussian_barycentre_1d_fixed_point(
            jnp.asarray(means[:, j]), jnp.asarray(stds[:, j]), jnp.asarray(w[:, j]), return_iters=True)
        np.testing.assert_allclose(float(one[1]), float(want[1]), rtol=0, atol=TOL, equal_nan=True)
        assert int(one[2]) == int(want[2]) == int(iters[j])
    two = tws.gaussian_barycentre_1d_fixed_point(t(means[:, 0].copy()), t(stds[:, 0].copy()),
                                                 t(w[:, 0].copy()))
    assert len(two) == 2


@pytest.mark.parametrize("sigma_mode", ["w2", "mixture", "compat"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_batched_barycentre_matches_jax(sigma_mode, use_mask):
    rng = np.random.default_rng(6)
    m, n = 4, 9
    means, stds = rng.normal(size=(m, n)), rng.uniform(0.2, 1.5, size=(m, n))
    w = rng.uniform(size=(m, n))
    mask = np.ones((m, n))
    mask[2] = 0.0
    w /= (w * mask).sum(axis=0) if use_mask else w.sum(axis=0)
    t = torch.from_numpy
    got = tws.batched_gaussian_barycentre(t(means), t(stds), t(w), t(mask) if use_mask else None,
                                          sigma_mode=sigma_mode)
    want = jws.batched_gaussian_barycentre(
        jnp.asarray(means), jnp.asarray(stds), jnp.asarray(w),
        jnp.asarray(mask) if use_mask else None, sigma_mode=sigma_mode)
    assert len(got) == len(want) == (3 if sigma_mode == "compat" else 2)
    close(got[0], want[0])
    close(got[1], want[1])
    if sigma_mode == "compat":
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        alias = tws.batched_gaussian_barycentre(t(means), t(stds), t(w),
                                                t(mask) if use_mask else None, compat_fixed_point=True)
        assert torch.equal(alias[1], got[1])


def test_batched_barycentre_leading_axes_and_per_model_weights():
    """The fused step's use: (S, M, T) moments and one weight per model."""
    rng = np.random.default_rng(7)
    s, m, n = 2, 3, 5
    means, stds = rng.normal(size=(s, m, n)), rng.uniform(0.2, 1.5, size=(s, m, n))
    w = rng.uniform(size=(s, m))
    w /= w.sum(axis=1, keepdims=True)
    t = torch.from_numpy
    for mode in ("w2", "mixture", "compat"):
        got = tws.batched_gaussian_barycentre(t(means), t(stds), t(w)[..., None], sigma_mode=mode)
        for i in range(s):
            want = jws.batched_gaussian_barycentre(
                jnp.asarray(means[i]), jnp.asarray(stds[i]),
                jnp.asarray(np.broadcast_to(w[i][:, None], (m, n))), sigma_mode=mode)
            close(got[0][i], want[0])
            close(got[1][i], want[1])
    with pytest.raises(ValueError, match="sigma_mode"):
        tws.batched_gaussian_barycentre(t(means), t(stds), t(w)[..., None], sigma_mode="w3")
