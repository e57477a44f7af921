"""The port's fit routes against the JAX package, in float64: the per-model
damped BFGS, the host-chunked fit, the coarse-to-fine-in-time fit and the
dispatch that routes between them, alone and through the ensemble step.

Tolerances: as in test_torch_gp.py, the two packages run the same steps
through different (backward-stable) solvers, so a few steps agree to 1e-9
relative.  BFGS accepts or rejects each proposal on a strict comparison;
on these inputs no comparison is near a tie, so the trajectories stay
together at the same tolerance.  A chunked fit repeats the merged fit's
steps exactly: it is held bit for bit.  Through the whole step the moments
agree to 1e-8, as in test_torch_step.py.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import gp as jgp
from bayesian_ensembling_tpu.parallel import step as jstep
from bayesian_ensembling_tpu_torch import convert
from bayesian_ensembling_tpu_torch.ops import gp as tgp
from bayesian_ensembling_tpu_torch.parallel import step as tstep

from test_torch_gp import make_block
from test_torch_step import scenario_blocks

torch.set_num_threads(1)

RTOL = 1e-9
STEP_TOL = 1e-8


def _inputs(seed, t=20):
    block, mask = make_block(seed, t=t)
    x, y, v = jgp.prepare_gp_inputs(jnp.asarray(block), jnp.asarray(mask), dba_iterations=2)
    return np.array(x), np.array(y), np.array(v)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_init(ls, var):
    return jgp.GPParams(raw_lengthscale=jnp.asarray(ls), raw_variance=jnp.asarray(var))


def _assert_fit_close(got, want, rtol=RTOL):
    tp, tl = got
    jp, jl = want
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol)
    np.testing.assert_allclose(tp.raw_lengthscale.detach().numpy(), np.asarray(jp.raw_lengthscale),
                               rtol=rtol)
    np.testing.assert_allclose(tp.raw_variance.detach().numpy(), np.asarray(jp.raw_variance),
                               rtol=rtol)


@pytest.mark.parametrize("kernel_name", ["matern32", "rbf"])
def test_bfgs_matches_jax_step_for_step(kernel_name):
    x, y, v = _inputs(2)
    want = jgp.fit_gp_batch(*map(jnp.asarray, (x, y, v)), kernel_name=kernel_name,
                            n_optim_nits=8, optimizer="bfgs")
    got = tgp.fit_gp_batch(*_torch(x, y, v), kernel_name=kernel_name, n_optim_nits=8,
                           optimizer="bfgs")
    _assert_fit_close(got, want)
    assert (got[1][:, -1] < got[1][:, 0]).all()  # every model improved


def test_bfgs_rescues_a_model_that_starts_non_finite():
    """Model 1 starts at a NaN lengthscale: its NLML is NaN, no proposal can
    be accepted, and the step resets it to the scratch init with a fresh
    optimiser state; it then converges like the others."""
    x, y, v = _inputs(3)
    ls = np.array([0.3, np.nan, -0.4])
    var = np.array([0.1, 0.2, 0.5])
    want = jgp.fit_gp_batch(*map(jnp.asarray, (x, y, v)), n_optim_nits=6, optimizer="bfgs",
                            init=_jax_init(ls, var))
    init = convert.gp_params_from_jax(ls, var, "cpu", torch.float64)
    with pytest.warns(UserWarning, match=r"model\(s\) \[1\] of 3 went non-finite.*bfgs reset"):
        got = tgp.fit_gp_batch(*_torch(x, y, v), n_optim_nits=6, optimizer="bfgs", init=init)
    _assert_fit_close(got, want)
    assert np.isnan(got[1][1, 0].item()) and torch.isfinite(got[1][:, 1:]).all()


@pytest.mark.parametrize("optimizer", ["adam", "bfgs"])
@pytest.mark.parametrize("chunk_steps", [1, 3, 4, 20])
def test_chunked_fit_equals_merged_and_jax(optimizer, chunk_steps):
    x, y, v = _inputs(4)
    n = 7
    merged = tgp.fit_gp_batch(*_torch(x, y, v), n_optim_nits=n, optimizer=optimizer)
    got = tgp.fit_gp_batch_chunked(*_torch(x, y, v), n_optim_nits=n, optimizer=optimizer,
                                   chunk_steps=chunk_steps)
    assert got[1].shape == (3, n)
    assert torch.equal(got[1], merged[1])
    assert torch.equal(got[0].raw_lengthscale, merged[0].raw_lengthscale)
    assert torch.equal(got[0].raw_variance, merged[0].raw_variance)
    want = jgp.fit_gp_batch_chunked(*map(jnp.asarray, (x, y, v)), n_optim_nits=n,
                                    optimizer=optimizer, chunk_steps=chunk_steps)
    _assert_fit_close(got, want)


def test_segment_carries_the_optimiser_state():
    x, y, v = _torch(*_inputs(5))
    params = tgp.init_params(3, device="cpu", dtype=torch.float64)
    opt = tgp._make_batch_opt("adam", 0.01, params)
    params, opt, l1 = tgp.fit_gp_batch_segment(x, y, v, params, opt, n_steps=2)
    params, opt, l2 = tgp.fit_gp_batch_segment(x, y, v, params, opt, n_steps=3)
    assert opt.count == 5 and l1.shape == (3, 2) and l2.shape == (3, 3)
    merged = tgp.fit_gp_batch(x, y, v, n_optim_nits=5)
    assert torch.equal(torch.cat([l1, l2], dim=1), merged[1])


@pytest.mark.parametrize("optimizer", ["adam", "bfgs"])
@pytest.mark.parametrize("time_stride,chunk_steps", [(3, None), (4, 2), (1, None)])
def test_warm_time_matches_jax(optimizer, time_stride, chunk_steps):
    x, y, v = _inputs(6, t=24)
    kw = dict(time_stride=time_stride, coarse_steps=5, fine_steps=3, optimizer=optimizer,
              chunk_steps=chunk_steps)
    want = jgp.fit_gp_batch_warm_time(*map(jnp.asarray, (x, y, v)), **kw)
    got = tgp.fit_gp_batch_warm_time(*_torch(x, y, v), **kw)
    assert got[1].shape == (3, 8)
    _assert_fit_close(got, want)


def test_warm_time_with_init_matches_jax():
    x, y, v = _inputs(7, t=24)
    ls, var = np.array([0.2, -0.1, 0.4]), np.array([0.3, 0.0, -0.2])
    want = jgp.fit_gp_batch_warm_time(*map(jnp.asarray, (x, y, v)), time_stride=2,
                                      coarse_steps=4, fine_steps=2, init=_jax_init(ls, var))
    init = convert.gp_params_from_jax(ls, var, "cpu", torch.float64)
    got = tgp.fit_gp_batch_warm_time(*_torch(x, y, v), time_stride=2, coarse_steps=4,
                                     fine_steps=2, init=init)
    _assert_fit_close(got, want)
    np.testing.assert_array_equal(init.raw_lengthscale.detach().numpy(), ls)  # copied


@pytest.mark.parametrize(
    "route",
    [dict(), dict(chunk_steps=2), dict(time_stride=3, fine_steps=2),
     dict(time_stride=3, fine_steps=2, chunk_steps=1)],
)
def test_dispatch_routes_match_jax(route):
    x, y, v = _inputs(8)
    want = jgp.fit_gp_batch_dispatch(*map(jnp.asarray, (x, y, v)), n_optim_nits=4, **route)
    got = tgp.fit_gp_batch_dispatch(*_torch(x, y, v), n_optim_nits=4, **route)
    _assert_fit_close(got, want)


@pytest.mark.parametrize(
    "kw,error,match",
    [
        (dict(time_stride=0), ValueError, "time_stride must be >= 1"),
        (dict(fine_steps=2), ValueError, "fine_steps was given without"),
        (dict(time_stride=2), ValueError, "requires fine_steps"),
        (dict(chunk_steps=0), ValueError, "chunk_steps must be positive"),
        (dict(time_stride=2, fine_steps=0), ValueError, "fine_steps must be positive"),
        (dict(optimizer="sgd"), ValueError, "unknown optimizer"),
    ],
)
def test_dispatch_errors(kw, error, match):
    x, y, v = _torch(*_inputs(1))
    with pytest.raises(error, match=match):
        tgp.fit_gp_batch_dispatch(x, y, v, n_optim_nits=1, **kw)


@pytest.mark.parametrize("route", [dict(), dict(chunk_steps=2)])
def test_dispatch_lbfgs_matches_jax(route):
    """``optimizer="lbfgs"`` through the dispatch, merged and chunked."""
    x, y, v = _inputs(1)
    want = jgp.fit_gp_batch_dispatch(*map(jnp.asarray, (x, y, v)), n_optim_nits=4,
                                     optimizer="lbfgs", **route)
    got = tgp.fit_gp_batch_dispatch(*_torch(x, y, v), n_optim_nits=4, optimizer="lbfgs", **route)
    _assert_fit_close(got, want, rtol=STEP_TOL)


@pytest.mark.parametrize(
    "kw", [dict(optimizer="bfgs"), dict(time_stride=4, fine_steps=2)]
)
def test_multi_scenario_step_fit_routes_match_jax(kw):
    hb, hm, sb, sm, obs = scenario_blocks(12)
    mm = np.ones(hb.shape[:2])
    mm[1, 0] = 0.0
    kw = dict(n_optim_nits=5, dba_iterations=2, **kw)
    want = jstep.ensemble_multi_scenario_step(*(jnp.asarray(a) for a in (hb, hm, sb, sm, obs, mm)), **kw)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="fit_gp_batch")
        got = tstep.ensemble_multi_scenario_step(*_torch(hb, hm, sb, sm, obs, mm), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=STEP_TOL)


def test_bfgs_first_step_strands_a_flagship_model_like_jax():
    """ROADMAP C7, a fault of the reference's damped BFGS that the port
    keeps: on one model of the synthetic flagship inputs (chip_smoke.py,
    seed 0, historical model 64) the first step, -g/2 from the scratch
    init, lands on a plateau of vanishing signal variance whose NLML is
    below the init's, and no later step leaves it.  Both packages take the
    same step; Adam reaches a far lower NLML."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hb, hm, *_ = smoke.synthetic_flagship(0)
    block = hb.reshape(-1, *hb.shape[2:])[64:65]
    mask = hm.reshape(-1, hm.shape[2])[64:65]
    x, y, v = (np.array(a) for a in jgp.prepare_gp_inputs(jnp.asarray(block), jnp.asarray(mask),
                                                           dba_iterations=10))
    want = jgp.fit_gp_batch(*map(jnp.asarray, (x, y, v)), n_optim_nits=3, optimizer="bfgs")
    got = tgp.fit_gp_batch(*_torch(x, y, v), n_optim_nits=3, optimizer="bfgs")
    _assert_fit_close(got, want)
    assert got[0].raw_variance.item() < -10.0  # signal variance below 5e-5
    losses = got[1][0].numpy()
    assert losses[1] < losses[0] - 40.0  # the first step is accepted ...
    np.testing.assert_allclose(losses[2], losses[1], rtol=1e-9)  # ... and the fit stays there
    _, adam = tgp.fit_gp_batch(*_torch(x, y, v), n_optim_nits=200)
    assert adam[0, -1] < got[1][0, -1] - 10.0
