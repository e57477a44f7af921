"""The port's weighting surface against the JAX package, in float64: the
scorers, every weight kind through ``fused_raw_weights`` and the
multi-scenario tail (with padded models), the ensemble step with a
non-default kind, and the float64 refinement ``refined_multi_scenario_f64``.

Tolerances: the weights and the tail are the same elementwise arithmetic on
both sides up to the order of sums, so they agree to 1e-12 relative (the
KSD's n x n sums and pow to 1e-11).  The refinement reruns the posterior
through different solvers at the same hyperparameters and targets: 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import gp as jgp
from bayesian_ensembling_tpu.ops import scoring as jscoring
from bayesian_ensembling_tpu.parallel import step as jstep
from bayesian_ensembling_tpu_torch import convert
from bayesian_ensembling_tpu_torch.ops import scoring as tscoring
from bayesian_ensembling_tpu_torch.parallel import step as tstep

from test_torch_step import KW, scenario_blocks

torch.set_num_threads(1)

RTOL = 1e-12
KSD_RTOL = 1e-11
REFINED_TOL = 1e-10


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def marginals(seed, s=2, m=4, t=9, r=3, r_obs=6):
    """Posterior-like moments, raw blocks with ragged masks, and one padded
    model slot per scenario."""
    rng = np.random.default_rng(seed)
    mean = np.linspace(0.0, 1.0, t) + 0.3 * rng.normal(size=(s, m, t))
    var = rng.uniform(0.01, 0.2, size=(s, m, t))
    obs = np.linspace(0.0, 1.0, t) + 0.2 * rng.normal(size=(r_obs, t))
    block = mean[:, :, None, :] + 0.2 * rng.normal(size=(s, m, r, t))
    mask = np.ones((s, m, r), bool)
    mask[0, 1, 2] = mask[1, 2, 1:] = False
    block[~mask] = 0.0
    mmask = np.ones((s, m))
    mmask[:, -1] = 0.0
    mean[:, -1] = 5.0  # a junk padded model, far from everything
    return mean, var, obs, block, mask, mmask


def test_scorers_match_jax():
    mean, var, obs, *_ = marginals(0)
    mu, v = mean[0, 0], var[0, 0]
    np.testing.assert_allclose(
        tscoring.diag_log_likelihood(*_torch(mu, v, obs)).numpy(),
        np.asarray(jscoring.diag_log_likelihood(*map(jnp.asarray, (mu, v, obs)))), rtol=RTOL)
    x, g = obs[:, 2], -(obs[:, 2] - mu[2]) / v[2]
    np.testing.assert_allclose(
        tscoring.imq_k0_matrix(*_torch(x, g)).numpy(),
        np.asarray(jscoring.imq_k0_matrix(jnp.asarray(x), jnp.asarray(g))), rtol=RTOL)
    np.testing.assert_allclose(
        tscoring.imq_ksd_1d(*_torch(x, g), c=0.7, beta=-0.3).item(),
        float(jscoring.imq_ksd_1d(jnp.asarray(x), jnp.asarray(g), c=0.7, beta=-0.3)), rtol=KSD_RTOL)
    # The batched KSD over (S, M) leading axes equals the JAX function per model.
    got = tscoring.batched_imq_ksd(*_torch(mean, np.sqrt(var), obs)).numpy()
    for si in range(mean.shape[0]):
        for mi in range(mean.shape[1]):
            want = jscoring.batched_imq_ksd(jnp.asarray(mean[si, mi]), jnp.asarray(np.sqrt(var[si, mi])),
                                            jnp.asarray(obs))
            np.testing.assert_allclose(got[si, mi], np.asarray(want), rtol=KSD_RTOL)


@pytest.mark.parametrize("weight_kind", jstep.WEIGHT_KINDS)
@pytest.mark.parametrize("use_mask", [False, True])
def test_fused_raw_weights_match_jax(weight_kind, use_mask):
    mean, var, obs, block, mask, mmask = (a[0] if a.ndim > 1 and a.shape[0] == 2 else a
                                          for a in marginals(1))
    mm = mmask if use_mask else None
    want = jstep.fused_raw_weights(weight_kind, jnp.asarray(mean), jnp.asarray(var), jnp.asarray(obs),
                                   jnp.asarray(block), jnp.asarray(mask),
                                   None if mm is None else jnp.asarray(mm))
    got = tstep.fused_raw_weights(weight_kind, *_torch(mean, var, obs, block, mask),
                                  None if mm is None else torch.from_numpy(mm))
    assert got.shape == mean.shape
    rtol = KSD_RTOL if weight_kind == "ksd" else RTOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)


@pytest.mark.parametrize("weight_kind", jstep.WEIGHT_KINDS)
def test_multi_scenario_tail_kinds_match_jax(weight_kind):
    mean, var, obs, block, mask, mmask = marginals(2)
    s, m, t = mean.shape
    rng = np.random.default_rng(3)
    smu, svar = rng.normal(size=(s, m, 5)), rng.uniform(0.01, 0.1, (s, m, 5))
    args = (mean, var, smu, svar, obs, block, mask, mmask)
    want = jstep.multi_scenario_tail(*map(jnp.asarray, args), weight_kind=weight_kind)
    got = tstep.multi_scenario_tail(*_torch(*args), weight_kind=weight_kind)
    rtol = KSD_RTOL if weight_kind == "ksd" else RTOL
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=1e-15)
    np.testing.assert_allclose(got[2].sum(dim=1).numpy(), 1.0, rtol=1e-12)
    assert (got[2][:, -1] == 0).all()  # the padded slot takes no weight


@pytest.mark.parametrize("weight_kind", ["loglik", "similarity"])
def test_scenario_step_weight_kinds_match_jax(weight_kind):
    hb, hm, sb, sm, obs = (a[0] if a.ndim > 2 else a for a in scenario_blocks(13, s=1))
    mm = np.array([1.0, 1.0, 0.0])
    want = jstep.ensemble_scenario_step(*(jnp.asarray(a) for a in (hb, hm, sb, sm, obs, mm)),
                                        weight_kind=weight_kind, **KW)
    got = tstep.ensemble_scenario_step(*_torch(hb, hm, sb, sm, obs, mm), weight_kind=weight_kind,
                                       **KW)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-8)


def test_weight_options_refused():
    mean, var, obs, *_ = (a[0] for a in marginals(4)[:3])
    with pytest.raises(ValueError, match="unknown weight_kind"):
        tstep.fused_raw_weights("nope", *_torch(mean, var, obs))
    with pytest.raises(ValueError, match="inverse_square needs"):
        tstep.fused_raw_weights("inverse_square", *_torch(mean, var, obs))


def _fitted(hb, hm, sb, sm):
    """JAX-fitted hyperparameters and DBA targets of both collections."""
    s, m, r, t_h = hb.shape
    out = []
    for block, mask in ((hb, hm), (sb, sm)):
        b2, m2 = jnp.asarray(block.reshape(s * m, r, -1)), jnp.asarray(mask.reshape(s * m, r))
        x, y, v = jgp.prepare_gp_inputs(b2, m2, dba_iterations=2)
        params, _ = jgp.fit_gp_batch(x, y, v, n_optim_nits=4)
        out.append((params, (np.array(y), np.array(v))))
    return out


@pytest.mark.parametrize("weight_kind,sigma_mode,give_targets",
                         [("crps", "w2", True), ("ksd", "mixture", False),
                          ("inverse_square", "w2", False)])
def test_refined_multi_scenario_f64_matches_jax(weight_kind, sigma_mode, give_targets):
    hb, hm, sb, sm, obs = scenario_blocks(14)
    mm = np.ones(hb.shape[:2])
    mm[0, 2] = 0.0
    (hp, htg), (sp, stg) = _fitted(hb, hm, sb, sm)
    kw = dict(dba_iterations=2, weight_kind=weight_kind, sigma_mode=sigma_mode)
    want = jstep.refined_multi_scenario_f64(
        *map(jnp.asarray, (hb, hm, sb, sm, obs, mm)), hp, sp,
        targets=(htg, stg) if give_targets else None, device="cpu", **kw)

    def port(p):
        return convert.gp_params_from_jax(np.asarray(p.raw_lengthscale),
                                          np.asarray(p.raw_variance), "cpu", torch.float64)

    got = tstep.refined_multi_scenario_f64(
        hb, hm, sb, sm, obs, mm, port(hp), port(sp),
        targets=(htg, stg) if give_targets else None, device="cpu", **kw)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=0, atol=REFINED_TOL)


def test_refined_multi_scenario_f64_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    hb, hm, sb, sm, obs = scenario_blocks(15)
    params = convert.gp_params_from_jax(np.zeros(6), np.zeros(6), "cpu", torch.float64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstep.refined_multi_scenario_f64(hb, hm, sb, sm, obs, np.ones((2, 3)), params, params)


def _crps_expression(obs, mu, sigma):
    """The closed-form CRPS as one expression, the form ``scoring.gaussian_crps``
    computes in place."""
    z = (obs - mu) / sigma
    cdf = 0.5 * (1.0 + torch.erf(z * tscoring._INV_SQRT_2))
    pdf = tscoring._INV_SQRT_2PI * torch.exp(-0.5 * (z * z))
    return sigma * (z * (2.0 * cdf - 1.0) + 2.0 * pdf - tscoring._INV_SQRT_PI)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(), (40, 9), (3, 5, 40, 9)])
def test_gaussian_crps_in_place_equals_the_expression(dtype, shape):
    gen = torch.Generator().manual_seed(len(shape))
    obs = torch.randn(shape, generator=gen, dtype=dtype)
    mu = torch.randn(shape[:-2] + (1,) + shape[-1:] if shape else (), generator=gen, dtype=dtype)
    sigma = 0.1 + torch.rand(mu.shape, generator=gen, dtype=dtype)
    assert torch.equal(tscoring.gaussian_crps(obs, mu, sigma), _crps_expression(obs, mu, sigma))


@pytest.mark.parametrize("which", ["obs", "mu", "sigma"])
def test_gaussian_crps_refuses_inputs_that_require_grad(which):
    """In place, the CRPS has no gradient: an input that requires grad
    raises, and under ``torch.no_grad()`` the same call gives the value."""
    gen = torch.Generator().manual_seed(2)
    args = dict(obs=torch.randn((5, 9), generator=gen, dtype=torch.float64),
                mu=torch.randn((1, 9), generator=gen, dtype=torch.float64),
                sigma=0.1 + torch.rand((1, 9), generator=gen, dtype=torch.float64))
    args[which].requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        tscoring.gaussian_crps(**args)
    with torch.no_grad():
        got = tscoring.gaussian_crps(**args)
    assert torch.equal(got, _crps_expression(*(a.detach() for a in args.values())))


def test_gridded_crps_in_place_equals_the_expression_under_vmap():
    """The gridded tail maps ``mean_gaussian_crps`` over cells with vmap."""
    gen = torch.Generator().manual_seed(1)
    mean, sd = torch.randn((4, 6, 11), generator=gen), 0.1 + torch.rand((4, 6, 11), generator=gen)
    obs = torch.randn((6, 30, 11), generator=gen)
    cells = torch.func.vmap(tscoring.mean_gaussian_crps, in_dims=(1, 1, 0), out_dims=1)
    want = torch.func.vmap(lambda m, s, o: torch.mean(_crps_expression(o, m[:, None], s[:, None]),
                                                      dim=-2), in_dims=(1, 1, 0), out_dims=1)
    assert torch.equal(cells(mean, sd, obs), want(mean, sd, obs))
