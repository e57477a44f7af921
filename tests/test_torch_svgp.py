"""The port's SVGP (``ops/svgp.py``) against the JAX package, in float64.

At fixed parameters (carried over with ``convert.svgp_params_from_jax``)
every function is the same arithmetic on both sides: the kernel, the
variational square root and the KL to 1e-12, the predictive marginals (a
Cholesky and a triangular solve of other libraries) to 1e-10.  The fit
takes JAX's own minibatch indices, put into the port's one drawing helper
(``ops.svgp._minibatch_indices``; JAX's threefry draws cannot be
reproduced, ROADMAP North star "Randomness"): with the same minibatches
both sides take the same Adam steps, and the marginals and the loss trace
agree to 1e-6 after tens of steps.  Not closer, because Adam divides each
step by the root of its second moment: at the identity initialisation the
gradients of the lengthscales and the inducing points are zero in exact
arithmetic, and whatever round-off either side leaves there (XLA's fused
program, torch's kernels) becomes a step of lr |g| / (|g| + 1e-8), up to
1e-7 for |g| ~ 1e-13; later steps compound it (measured: 1e-8 after one
step, 9e-7 after 30, in float64).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import svgp as jsvgp
from bayesian_ensembling_tpu_torch import convert
from bayesian_ensembling_tpu_torch.ops import svgp as tsvgp

torch.set_num_threads(1)

TOL = 1e-12
MARGINAL_TOL = 1e-10
FIT_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _jax_indices(seed, start, n_steps, batch, n):
    """The minibatches ``bayesian_ensembling_tpu.ops.svgp._svgp_run_chunk``
    draws at absolute steps ``start .. start + n_steps - 1``."""
    key = jax.random.PRNGKey(seed)
    return np.stack([
        np.asarray(jax.random.randint(jax.random.fold_in(key, i), (batch,), 0, n))
        for i in range(start, start + n_steps)
    ]).astype(np.int64)


@pytest.fixture
def jax_minibatches(monkeypatch):
    monkeypatch.setattr(
        tsvgp, "_minibatch_indices",
        lambda seed, start, k, b, n: torch.from_numpy(_jax_indices(seed, start, k, b, n)),
    )


def features(seed, n=60, d=6):
    """Reference-layout features: unit-sphere xyz, time in [-1, 1], then
    realisation columns; a smooth target and known noise."""
    rng = np.random.default_rng(seed)
    lat = np.deg2rad(rng.uniform(-80, 80, n))
    lon = np.deg2rad(rng.uniform(0, 360, n))
    t = np.linspace(-1.0, 1.0, n)
    x = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat), t], axis=1)
    x = np.concatenate([x, 0.3 * rng.normal(size=(n, d - 4))], axis=1)
    y = np.sin(2.0 * t) + 0.5 * x[:, 2] + 0.05 * rng.normal(size=n)
    noise = rng.uniform(0.01, 0.05, n)
    return x, y, noise


def perturbed_params(x, p, seed):
    """JAX's initial parameters moved off the identity, so that every term
    of every function is exercised."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jsvgp._svgp_init(jnp.asarray(x), p))
    return {k: v + 0.1 * rng.normal(size=v.shape) for k, v in params.items()}


def _both(params):
    return (jax.tree.map(jnp.asarray, params),
            convert.svgp_params_from_jax(params, "cpu", torch.float64))


@pytest.mark.parametrize("d", [4, 5, 7])
def test_default_feature_groups_match_jax(d):
    assert tsvgp.default_feature_groups(d) == jsvgp.default_feature_groups(d)


def test_default_feature_groups_reject_narrow_layouts():
    with pytest.raises(ValueError, match="4 features"):
        tsvgp.default_feature_groups(3)


@pytest.mark.parametrize("p", [1, 7, 16])
def test_init_matches_jax(p):
    x, _, _ = features(0)
    want = jsvgp._svgp_init(jnp.asarray(x), p)
    got = tsvgp._svgp_init(torch.from_numpy(x), p)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_amplitude_ls_matrix_and_kl_match_jax(seed):
    x, _, _ = features(seed)
    jp, tp_ = _both(perturbed_params(x, 9, seed))
    groups = jsvgp.default_feature_groups(x.shape[1])
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(
        tsvgp._additive_matern32(tp_, tp_["z"], xt, groups).numpy(),
        np.asarray(jsvgp._additive_matern32(jp, jp["z"], xj, groups)), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(tsvgp._amplitude(tp_, groups)),
                               float(jsvgp._amplitude(jp, groups)), rtol=TOL)
    np.testing.assert_allclose(tsvgp._kdiag(tp_, xt, groups).numpy(),
                               np.asarray(jsvgp._kdiag(jp, xj, groups)), rtol=TOL)
    np.testing.assert_allclose(tsvgp._ls_matrix(tp_).numpy(), np.asarray(jsvgp._ls_matrix(jp)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(float(tsvgp._kl(tp_)), float(jsvgp._kl(jp)), rtol=TOL)


@pytest.mark.parametrize("seed,jitter", [(0, 1e-4), (1, 1e-6)])
def test_marginals_match_jax(seed, jitter):
    x, _, _ = features(seed)
    jp, tp_ = _both(perturbed_params(x, 12, seed))
    groups = jsvgp.default_feature_groups(x.shape[1])
    want = jsvgp._marginals(jp, jnp.asarray(x[:25]), groups, jitter)
    got = tsvgp._marginals(tp_, torch.from_numpy(x[:25]), groups, jitter)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=MARGINAL_TOL)
    for g, w in zip(tsvgp._svgp_predict(tp_, torch.from_numpy(x), jitter),
                    jsvgp._svgp_predict(jp, jnp.asarray(x), jitter)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=MARGINAL_TOL)


def test_gradients_of_the_elbo_terms_match_jax():
    x, y, noise = features(2)
    jp, tp_ = _both(perturbed_params(x, 10, 2))
    groups = jsvgp.default_feature_groups(x.shape[1])

    def jloss(prm):
        mean, var = jsvgp._marginals(prm, jnp.asarray(x), groups, 1e-4)
        return jnp.sum(mean * jnp.asarray(y)) + jnp.sum(var) + jsvgp._kl(prm)

    want = jax.grad(jloss)(jp)
    tp_ = {k: v.requires_grad_() for k, v in tp_.items()}
    mean, var = tsvgp._marginals(tp_, torch.from_numpy(x), groups, 1e-4)
    loss = torch.sum(mean * torch.from_numpy(y)) + torch.sum(var) + tsvgp._kl(tp_)
    grads = torch.autograd.grad(loss, [tp_[k] for k in tsvgp._NAMES])
    for k, g in zip(tsvgp._NAMES, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=0,
                                   atol=MARGINAL_TOL * max(1.0, np.abs(np.asarray(want[k])).max()))


@pytest.mark.parametrize("n,kw", [
    (60, dict(n_inducing=12, minibatch_size=16, n_optim_nits=30, learning_rate=0.02)),
    (60, dict(n_inducing=8, minibatch_size=100, n_optim_nits=12, learning_rate=0.01, seed=3)),
    # More inducing points than points: P = N.
    (16, dict(n_inducing=100, minibatch_size=8, n_optim_nits=3, learning_rate=0.02, jitter=1e-3)),
])
def test_fit_predict_matches_jax_step_for_step(jax_minibatches, n, kw):
    x, y, noise = features(4, n=n)
    want = jsvgp.fit_predict_svgp(*map(jnp.asarray, (x, y, noise)), return_losses=True, **kw)
    got = tsvgp.fit_predict_svgp(*map(torch.from_numpy, (x, y, noise)), return_losses=True, **kw)
    assert got[0].shape == got[1].shape == (n,)
    np.testing.assert_allclose(got[2], want[2], rtol=FIT_TOL)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FIT_TOL)


@pytest.mark.parametrize("chunk_steps", [1, 7, 10_000])
def test_chunked_equals_monolithic(chunk_steps):
    """The draws fold the absolute step index in: any chunking gives the
    monolithic run's steps, bit for bit."""
    x, y, noise = features(5)
    kw = dict(n_inducing=10, minibatch_size=20, n_optim_nits=15, learning_rate=0.02)
    whole = tsvgp.fit_predict_svgp(*map(torch.from_numpy, (x, y, noise)), chunk_steps=10_000,
                                   return_losses=True, **kw)
    part = tsvgp.fit_predict_svgp(*map(torch.from_numpy, (x, y, noise)), chunk_steps=chunk_steps,
                                  return_losses=True, **kw)
    for a, b in zip(part[:2], whole[:2]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(part[2], whole[2])


def test_minibatch_indices_are_in_range_reproducible_and_fold_the_step():
    a = tsvgp._minibatch_indices(0, 0, 5, 32, 50)
    assert a.shape == (5, 32) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < 50
    assert torch.equal(a, tsvgp._minibatch_indices(0, 0, 5, 32, 50))
    assert torch.equal(a[2:], tsvgp._minibatch_indices(0, 2, 3, 32, 50))
    assert not torch.equal(a, tsvgp._minibatch_indices(1, 0, 5, 32, 50))
    assert not torch.equal(a[0], a[1])


def test_fit_learns_a_simple_function():
    """The JAX package's own check (tests/test_gp3d.py), on the port's
    draws: the time feature carries the signal."""
    rng = np.random.default_rng(0)
    n = 300
    x = np.zeros((n, 5))
    x[:, 3] = np.linspace(-1, 1, n)
    x[:, 0] = 1.0
    x[:, 4] = rng.normal(size=n) * 0.01
    y = np.sin(3 * x[:, 3])
    mean, var, losses = tsvgp.fit_predict_svgp(
        torch.from_numpy(x), torch.from_numpy(y), torch.full((n,), 0.01, dtype=torch.float64),
        n_inducing=40, minibatch_size=64, n_optim_nits=400, learning_rate=0.02,
        return_losses=True,
    )
    assert np.sqrt(np.mean((mean.numpy() - y) ** 2)) < 0.25
    assert (var > 0).all() and losses[-20:].mean() < losses[:20].mean()
