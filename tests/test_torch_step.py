"""The port's ensemble step against the JAX package, in float64, at a small
shape (S=2 scenarios, M=3 models, R=4 realisations, a few Adam steps).

Tolerance: the whole slice is the same algorithm on both sides; after the
DBA, a few Adam steps, the posterior and the tail, the barycentre moments
and weights agree to 1e-8 (round-off of different solvers, amplified
mildly by the fit).
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.parallel import step as jstep
from bayesian_ensembling_tpu_torch.parallel import step as tstep

torch.set_num_threads(1)

TOL = 1e-8
KW = dict(n_optim_nits=4, dba_iterations=2)


def scenario_blocks(seed, s=2, m=3, r=4, t_hist=16, t_ssp=10, r_obs=5):
    """GMST-like series: a trend, a per-model offset, AR(1) noise; ragged
    realisation counts, zero-padded."""
    rng = np.random.default_rng(seed)

    def series(t, shape, slope):
        noise = np.zeros(shape + (t,))
        eps = 0.1 * rng.normal(size=shape + (t,))
        for k in range(t):
            noise[..., k] = (0.6 * noise[..., k - 1] if k else 0.0) + eps[..., k]
        return slope * np.linspace(0.0, 1.0, t) + noise

    offset = 0.2 * rng.normal(size=(s, m, 1, 1))
    hb = series(t_hist, (s, m, r), 1.0) + offset
    sb = series(t_ssp, (s, m, r), 1.5) + offset + 1.0
    counts = rng.integers(1, r + 1, size=(s, m))
    counts[0, 0] = 1
    counts[-1, -1] = r
    mask = np.arange(r)[None, None, :] < counts[:, :, None]
    hb[~mask] = 0.0
    sb[~mask] = 0.0
    obs = series(t_hist, (r_obs,), 1.0)
    return hb, mask, sb, mask.copy(), obs


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_scenario_step_matches_jax(seed):
    hb, hm, sb, sm, obs = scenario_blocks(seed)
    mm = np.ones(hb.shape[:2])
    mm[1, 2] = 0.0  # one padded model slot
    want = jstep.ensemble_multi_scenario_step(*(jnp.asarray(a) for a in (hb, hm, sb, sm, obs, mm)), **KW)
    got = tstep.ensemble_multi_scenario_step(*_torch(hb, hm, sb, sm, obs, mm), **KW)
    assert got[0].shape == (2, 10) and got[2].shape == (2, 3)
    _close(got, want)
    np.testing.assert_allclose(got[2].sum(dim=1).numpy(), 1.0, rtol=1e-12)
    assert got[2][1, 2].item() == 0.0


@pytest.mark.parametrize("use_mask", [False, True])
def test_scenario_step_matches_jax(use_mask):
    hb, hm, sb, sm, obs = (a[0] if a.ndim > 2 else a for a in scenario_blocks(3, s=1))
    mm = np.array([1.0, 1.0, 0.0]) if use_mask else None
    args = (hb, hm, sb, sm, obs) + ((mm,) if use_mask else ())
    want = jstep.ensemble_scenario_step(*(jnp.asarray(a) for a in args), **KW)
    got = tstep.ensemble_scenario_step(*_torch(*args), **KW)
    assert got[0].shape == (10,) and got[2].shape == (3,)
    _close(got, want)


@pytest.mark.parametrize("sigma_mode", ["w2", "mixture"])
def test_multi_scenario_tail_matches_jax(sigma_mode):
    rng = np.random.default_rng(4)
    s, m, th, ts = 2, 3, 12, 7
    hmu, smu = rng.normal(size=(s, m, th)), rng.normal(size=(s, m, ts))
    hvar, svar = rng.uniform(0.01, 0.1, (s, m, th)), rng.uniform(0.01, 0.1, (s, m, ts))
    obs = rng.normal(size=(5, th))
    mm = np.array([[1.0, 1.0, 1.0], [1.0, 0.0, 1.0]])
    hb, hmask = np.zeros((s, m, 2, th)), np.ones((s, m, 2), bool)
    want = jstep.multi_scenario_tail(
        *(jnp.asarray(a) for a in (hmu, hvar, smu, svar, obs, hb, hmask, mm)), sigma_mode=sigma_mode
    )
    got = tstep.multi_scenario_tail(
        *_torch(hmu, hvar, smu, svar, obs, hb, hmask, mm), sigma_mode=sigma_mode
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13, atol=1e-15)


def test_padded_models_are_neutral():
    hb, hm, sb, sm, obs = (a[0] if a.ndim > 2 else a for a in scenario_blocks(5, s=1))
    base = tstep.ensemble_scenario_step(*_torch(hb, hm, sb, sm, obs), **KW)
    hb5, hm5, mmask = tstep.pad_models(hb, hm, 5)
    sb5, sm5, _ = tstep.pad_models(sb, sm, 5)
    padded = tstep.ensemble_scenario_step(*_torch(hb5, hm5, sb5, sm5, obs, mmask), **KW)
    np.testing.assert_allclose(padded[0].numpy(), base[0].numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(padded[1].numpy(), base[1].numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(padded[2][:3].numpy(), base[2].numpy(), rtol=0, atol=1e-10)
    assert (padded[2][3:] == 0).all()


def test_pad_models_matches_jax():
    hb, hm, *_ = scenario_blocks(6, s=1)
    got = tstep.pad_models(hb[0], hm[0], 6)
    want = jstep.pad_models(hb[0], hm[0], 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="m_target"):
        tstep.pad_models(hb[0], hm[0], 2)


@pytest.mark.parametrize("option", [dict(optimizer="lbfgs")])
def test_once_unported_options_match_jax(option):
    """What the port once lacked (``optimizer="lbfgs"``) runs as the JAX
    package's does."""
    hb, hm, sb, sm, obs = scenario_blocks(7)
    mm = np.ones(hb.shape[:2])
    kw = dict(KW, **option)
    want = jstep.ensemble_multi_scenario_step(*(jnp.asarray(a) for a in (hb, hm, sb, sm, obs, mm)), **kw)
    got = tstep.ensemble_multi_scenario_step(*_torch(hb, hm, sb, sm, obs, mm), **kw)
    _close(got, want)


def test_emulate_marginals_return_flags():
    hb, hm, *_ = scenario_blocks(8, s=1)
    block, mask = _torch(hb[0], hm[0])
    mean, var, params, y_mean, y_var = tstep.emulate_marginals(
        block, mask, n_optim_nits=2, dba_iterations=1, return_params=True, return_targets=True
    )
    assert mean.shape == var.shape == y_mean.shape == y_var.shape == (3, 16)
    assert params.raw_lengthscale.shape == (3,)
    assert (var > y_var).all()
    with pytest.raises(ValueError, match="return_targets"):
        tstep.emulate_marginals(block, mask, return_targets=True)


def test_imports_without_jax():
    """The whole port, every module of it (the examples, the entry scripts,
    the lbfgs optimiser, the native engine and the orbax backend among
    them), imports with JAX, flax and optax blocked, runs nothing at
    import, and pulls in nothing of the JAX package."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'flax', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import bayesian_ensembling_tpu_torch as bt\n"
        "for info in pkgutil.walk_packages(bt.__path__, bt.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "for name in ('data', 'coords', 'weights', 'schemes', 'metrics', 'pipeline',"
        " 'models.gp_dtw', 'models.mean_field', 'ops.distributions', 'ops.wasserstein',"
        " 'io.timeutils', 'utils.config', 'utils.profiles', 'models.gp_3d', 'ops.svgp',"
        " 'parallel.gridded', 'validation', 'utils.logging', 'utils.array_types',"
        " 'utils.profiling', 'ops.lbfgs', 'io.orbax_ckpt', 'native', 'examples.quickstart',"
        " 'examples.monthly_warm', 'examples.gridded_quickstart', 'examples.gridded_refined',"
        " 'cli.full_experiment', 'cli.pre_fit_models', 'cli.perfect_model_tests',"
        " 'cli.create_gmst', 'cli.extract_single_location'):\n"
        "    assert bt.__name__ + '.' + name in sys.modules, name\n"
        "bad = [m for m in sys.modules if m == 'bayesian_ensembling_tpu'"
        " or m.startswith('bayesian_ensembling_tpu.')]\n"
        "assert not bad, bad\n"
        "assert bt.launch_counts() == {'dba_update': 0, 'dba_update_split': 0, 'chol_solve': 0,"
        " 'tri_inv': 0, 'chol': 0, 'dtw_cost': 0, 'solve_vec': 0, 'gram_matern32': 0,"
        " 'gram_matern32_grad': 0}\n"
        "assert bt.route_counts() == {'kernel': 0, 'blocked': 0, 'library': 0}\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
