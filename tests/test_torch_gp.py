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
    """The optax L-BFGS route stays unported (ROADMAP A6b); the dispatch's
    own argument errors are those of the JAX package."""
    x, y, v = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A6b"):
        tgp.fit_gp_batch(x, y, v, n_optim_nits=1, optimizer="lbfgs")
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A6b"):
        tgp.fit_gp_batch_dispatch(x, y, v, n_optim_nits=1, time_stride=2, fine_steps=1,
                                  optimizer="lbfgs")
    with pytest.raises(ValueError, match="unknown optimizer"):
        tgp.fit_gp_batch(x, y, v, n_optim_nits=1, optimizer="sgd")
    with pytest.raises(ValueError, match="time_stride"):
        tgp.fit_gp_batch_dispatch(x, y, v, n_optim_nits=1, time_stride=0)
    with pytest.raises(ValueError, match="fine_steps"):
        tgp.fit_gp_batch_dispatch(x, y, v, n_optim_nits=1, fine_steps=2)


def _one_model_inputs(seed, t=12, d=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(t, d)), rng.normal(size=t), rng.uniform(0.05, 0.3, t)


# How a caller names the kernel: the JAX package's kernel= with the port's
# callable, the callable by position, the name by keyword, and kernel_name=.
SPELLINGS = ("kernel=callable", "positional", "kernel=name", "kernel_name=")


def _spell(spelling, kernel_name):
    kern = tgp.get_kernel(kernel_name)
    return {"kernel=callable": ((), dict(kernel=kern)), "positional": ((kern,), {}),
            "kernel=name": ((), dict(kernel=kernel_name)),
            "kernel_name=": ((), dict(kernel_name=kernel_name))}[spelling]


@pytest.mark.parametrize("spelling", SPELLINGS)
@pytest.mark.parametrize("kernel_name", ["matern32", "rbf"])
def test_single_model_api_takes_the_reference_arguments(kernel_name, spelling):
    """nlml, posterior and posterior_marginals take a GPParams and the kernel
    as the JAX functions do (ROADMAP C13), and match them in float64; the
    NLML's gradient in the GPParams leaves matches JAX's too."""
    x, y, nv = _one_model_inputs(3)
    jparams = jgp.GPParams(jnp.asarray(0.4), jnp.asarray(-0.2))
    params = tgp.GPParams(torch.tensor(0.4, dtype=torch.float64),
                          torch.tensor(-0.2, dtype=torch.float64))
    args, kw = _spell(spelling, kernel_name)
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(nv), jgp.get_kernel(kernel_name))
    targs = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(nv))
    got = tgp.nlml(params, *targs, *args, **kw)
    np.testing.assert_allclose(got.item(), float(jgp.nlml(jparams, *jargs)), rtol=0, atol=1e-10)
    got.backward()
    want = jax.grad(jgp.nlml)(jparams, *jargs)
    np.testing.assert_allclose([params.raw_lengthscale.grad.item(), params.raw_variance.grad.item()],
                               [float(want.raw_lengthscale), float(want.raw_variance)], atol=1e-10)
    for tf, jf in ((tgp.posterior, jgp.posterior), (tgp.posterior_marginals, jgp.posterior_marginals)):
        for g, w in zip(tf(params, *targs, *args, **kw), jf(jparams, *jargs)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


@pytest.mark.parametrize("kernel", ["matern32", "rbf"])
def test_fit_gp_returns_a_gpparams_the_single_model_api_takes(kernel):
    """fit_gp returns a one-model GPParams (0-d leaves, as JAX's), which
    nlml, posterior and posterior_marginals take; the fit, the NLML trace
    and the three functions at the fitted values match JAX in float64.
    The port's kernel callable is accepted in place of the name."""
    x, y, nv = _one_model_inputs(4)
    jp, jl = jgp.fit_gp(jnp.asarray(x), jnp.asarray(y), jnp.asarray(nv), kernel_name=kernel,
                        n_optim_nits=10)
    targs = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(nv))
    tp_, tl = tgp.fit_gp(*targs, tgp.get_kernel(kernel), n_optim_nits=10)
    assert isinstance(tp_, tgp.GPParams) and tp_.raw_lengthscale.shape == ()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-9)
    np.testing.assert_allclose([tp_.raw_lengthscale.item(), tp_.raw_variance.item()],
                               [float(jp.raw_lengthscale), float(jp.raw_variance)], atol=1e-9)
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(nv))
    jkern = jgp.get_kernel(kernel)
    np.testing.assert_allclose(tgp.nlml(tp_, *targs, kernel=kernel).item(),
                               float(jgp.nlml(jp, *jargs, kernel=jkern)), atol=1e-8)
    for tf, jf in ((tgp.posterior, jgp.posterior), (tgp.posterior_marginals, jgp.posterior_marginals)):
        for g, w in zip(tf(tp_, *targs, kernel_name=kernel), jf(jp, *jargs, kernel=jkern)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-8)


def test_single_model_api_takes_any_kernel_callable():
    """A kernel written by the caller, (params, x1, x2) -> K on the GPParams,
    as the JAX package allows."""
    x, y, nv = _one_model_inputs(5)

    def jperiodic(p, x1, x2):
        d = jnp.sqrt(jnp.sum((x1[:, None] - x2[None]) ** 2, axis=-1) + 1e-36)
        return p.variance * jnp.exp(-2.0 * jnp.sin(d / 2.0) ** 2 / p.lengthscale**2)

    def tperiodic(p, x1, x2):
        d = torch.sqrt(torch.sum((x1[:, None] - x2[None]) ** 2, dim=-1) + 1e-36)
        return p.variance * torch.exp(-2.0 * torch.sin(d / 2.0) ** 2 / p.lengthscale**2)

    jparams = jgp.GPParams(jnp.asarray(0.7), jnp.asarray(0.1))
    params = tgp.GPParams(torch.tensor(0.7, dtype=torch.float64),
                          torch.tensor(0.1, dtype=torch.float64))
    targs = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(nv))
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(nv))
    np.testing.assert_allclose(tgp.nlml(params, *targs, tperiodic).item(),
                               float(jgp.nlml(jparams, *jargs, jperiodic)), atol=1e-10)
    for g, w in zip(tgp.posterior_marginals(params, *targs, kernel=tperiodic),
                    jgp.posterior_marginals(jparams, *jargs, kernel=jperiodic)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


def test_single_model_api_refusals():
    x, y, nv = (torch.from_numpy(a) for a in _one_model_inputs(6))
    params = tgp.GPParams(torch.tensor(0.0, dtype=torch.float64), torch.tensor(0.0, dtype=torch.float64))
    with pytest.raises(TypeError, match="not both"):
        tgp.nlml(params, x, y, nv, tgp.rbf, kernel_name="rbf")
    with pytest.raises(ValueError, match="unknown kernel"):
        tgp.posterior(params, x, y, nv, kernel="periodic")
    with pytest.raises(ValueError, match="0-d"):
        tgp.GPParams(torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError, match="named kernels"):
        tgp.fit_gp(x, y, nv, lambda p, a, b: a @ b.T, n_optim_nits=1)
    with pytest.raises(ValueError, match="one model"):
        tgp.nlml(tgp.init_params(2, device="cpu", dtype=torch.float64), x, y, nv)
