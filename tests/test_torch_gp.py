"""The port's GP layer against the JAX package, in float64: the DBA
preamble, the Adam fit step for step, and the posterior marginals at
JAX-fitted hyperparameters carried across with ``gp_params_from_jax``.

Tolerances: the preamble and the posterior are the same arithmetic on both
sides up to the order of sums (1e-10).  The Adam trajectories run through
different (but backward-stable) solvers; after a few steps of lr 0.01 the
round-off stays far below 1e-9 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import gp as jgp
from bayesian_ensembling_tpu_torch import convert
from bayesian_ensembling_tpu_torch.ops import gp as tgp

torch.set_num_threads(1)


def make_block(seed, m=3, r=4, t=16):
    rng = np.random.default_rng(seed)
    trend = np.linspace(0.0, 1.0, t) ** 2
    block = trend + 0.3 * rng.normal(size=(m, 1, 1)) + 0.1 * rng.normal(size=(m, r, t))
    mask = np.ones((m, r), bool)
    mask[0, 2:] = False
    mask[1, 3] = False
    block[~mask] = 0.0
    return block, mask


def test_softplus_and_init_match_jax():
    x = np.linspace(-30.0, 30.0, 41)
    np.testing.assert_allclose(
        tgp.softplus(torch.from_numpy(x)).numpy(), np.asarray(jax.nn.softplus(x)), rtol=1e-15
    )
    p = tgp.init_params(3, device="cpu", dtype=torch.float64)
    j = jgp.init_params(dtype=jnp.float64)
    np.testing.assert_array_equal(p.raw_lengthscale.detach().numpy(), np.full(3, float(j.raw_lengthscale)))
    np.testing.assert_array_equal(p.raw_variance.detach().numpy(), np.full(3, float(j.raw_variance)))


@pytest.mark.parametrize("kernel_name", ["matern32", "rbf"])
def test_kernel_precompute_matches_jax(kernel_name):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 3))
    raw = rng.normal(size=(2, 2))
    jpre, japply = jgp.get_kernel_precomputed(kernel_name)
    want = [
        japply(jgp.GPParams(jnp.asarray(raw[b, 0]), jnp.asarray(raw[b, 1])), jpre(x[b], x[b]))
        for b in range(2)
    ]
    tpre, tapply = tgp.get_kernel_precomputed(kernel_name)
    params = convert.gp_params_from_jax(raw[:, 0], raw[:, 1], "cpu", torch.float64)
    got = tapply(params, tpre(torch.from_numpy(x), torch.from_numpy(x))).detach()
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="unknown kernel"):
        tgp.get_kernel_precomputed("nope")


@pytest.mark.parametrize("dba_iterations", [1, 3])
def test_prepare_gp_inputs_matches_jax(dba_iterations):
    block, mask = make_block(dba_iterations)
    jx, jy, jv = jgp.prepare_gp_inputs(jnp.asarray(block), jnp.asarray(mask), dba_iterations=dba_iterations)
    x, y, v = tgp.prepare_gp_inputs(torch.from_numpy(block), torch.from_numpy(mask), dba_iterations=dba_iterations)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-12)
    assert v.min().item() >= 1e-8  # the single-realisation noise floor


def _inputs(seed, **kw):
    block, mask = make_block(seed, **kw)
    x, y, v = jgp.prepare_gp_inputs(jnp.asarray(block), jnp.asarray(mask), dba_iterations=2)
    return np.array(x), np.array(y), np.array(v)  # writable copies


@pytest.mark.parametrize("kernel_name", ["matern32", "rbf"])
def test_fit_gp_batch_matches_jax_step_for_step(kernel_name):
    x, y, v = _inputs(5)
    steps = 6
    jp, jl = jgp.fit_gp_batch(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v),
                              kernel_name=kernel_name, n_optim_nits=steps)
    tp, tl = tgp.fit_gp_batch(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(v),
                              kernel_name=kernel_name, n_optim_nits=steps)
    assert tl.shape == (3, steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-9)
    np.testing.assert_allclose(tp.raw_lengthscale.detach().numpy(), np.asarray(jp.raw_lengthscale), rtol=1e-9)
    np.testing.assert_allclose(tp.raw_variance.detach().numpy(), np.asarray(jp.raw_variance), rtol=1e-9)


def test_fit_gp_batch_warm_start_from_jax_params():
    x, y, v = _inputs(8)
    jp, _ = jgp.fit_gp_batch(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v), n_optim_nits=4)
    jp2, jl2 = jgp.fit_gp_batch(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v), n_optim_nits=3, init=jp)
    leaves = jax.tree.map(np.asarray, jp)
    init = convert.gp_params_from_jax(leaves.raw_lengthscale, leaves.raw_variance, "cpu", torch.float64)
    tp2, tl2 = tgp.fit_gp_batch(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(v),
                                n_optim_nits=3, init=init)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-9)
    back = convert.gp_params_to_numpy(tp2)
    np.testing.assert_allclose(back["raw_lengthscale"], np.asarray(jp2.raw_lengthscale), rtol=1e-9)
    # The warm start is copied, not modified in place.
    np.testing.assert_array_equal(init.raw_lengthscale.detach().numpy(), leaves.raw_lengthscale)


@pytest.mark.parametrize("kernel_name", ["matern32", "rbf"])
def test_posterior_marginals_at_jax_fitted_params(kernel_name):
    x, y, v = _inputs(9)
    jp, _ = jgp.fit_gp_batch(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v),
                             kernel_name=kernel_name, n_optim_nits=5)
    jm, jv = jgp.posterior_marginals_batch(jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(v),
                                           kernel_name=kernel_name)
    leaves = jax.tree.map(np.asarray, jp)
    params = convert.gp_params_from_jax(leaves.raw_lengthscale, leaves.raw_variance, "cpu", torch.float64)
    tm, tv = tgp.posterior_marginals_batch(params, torch.from_numpy(x), torch.from_numpy(y),
                                           torch.from_numpy(v), kernel_name=kernel_name)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8, atol=1e-12)
    assert tv.min().item() >= 1e-12


def test_fit_unported_options_raise():
    x, y, v = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(NotImplementedError, match="A6"):
        tgp.fit_gp_batch(x, y, v, n_optim_nits=1, optimizer="bfgs")
    with pytest.raises(NotImplementedError, match="A6"):
        tgp.fit_gp_batch_dispatch(x, y, v, n_optim_nits=1, time_stride=2, fine_steps=1)
    with pytest.raises(NotImplementedError, match="A6"):
        tgp.fit_gp_batch_dispatch(x, y, v, n_optim_nits=1, chunk_steps=1)
    with pytest.raises(ValueError, match="time_stride"):
        tgp.fit_gp_batch_dispatch(x, y, v, n_optim_nits=1, time_stride=0)
    with pytest.raises(ValueError, match="fine_steps"):
        tgp.fit_gp_batch_dispatch(x, y, v, n_optim_nits=1, fine_steps=2)
    block, mask = (torch.from_numpy(a) for a in make_block(0))
    with pytest.raises(NotImplementedError, match="A6"):
        tgp.prepare_gp_inputs(block, mask, dba_method="subgradient")
    with pytest.raises(NotImplementedError, match="A6"):
        tgp.prepare_gp_inputs(block, mask, dba_tol=1e-3)
