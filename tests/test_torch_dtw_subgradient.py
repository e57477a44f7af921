"""The port's stochastic subgradient DBA against the JAX package, in float64.

JAX draws each epoch's series orders with its threefry PRNG, which PyTorch
cannot reproduce; the tests put JAX's own orders into the port's one
drawing helper (``ops.dtw._epoch_orders``).  With identical orders both
sides take the same steps (the same DP moves, sums in the same order), so
barycentres and costs agree to 1e-10.  Through the whole step (S=2, M=3,
R=4, a few Adam steps) the moments agree to 1e-8, as in test_torch_step.py.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import dtw as jdtw
from bayesian_ensembling_tpu.ops import gp as jgp
from bayesian_ensembling_tpu.parallel import step as jstep
from bayesian_ensembling_tpu_torch.ops import dtw as tdtw
from bayesian_ensembling_tpu_torch.ops import gp as tgp
from bayesian_ensembling_tpu_torch.parallel import step as tstep

from test_torch_step import scenario_blocks

torch.set_num_threads(1)

TOL = 1e-10
STEP_TOL = 1e-8


@functools.lru_cache(maxsize=None)
def _jax_orders(seed, epoch, b, r):
    """The (B, R) orders ``bayesian_ensembling_tpu.ops.dtw.dba_subgradient_batch``
    draws in epoch ``epoch``."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), epoch), b)
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, r))(keys))


@pytest.fixture
def jax_orders(monkeypatch):
    monkeypatch.setattr(
        tdtw, "_epoch_orders",
        lambda seed, epoch, b, r: torch.from_numpy(_jax_orders(seed, epoch, b, r).astype(np.int64)),
    )


def stacks(seed, b=3, r=5, t=16):
    rng = np.random.default_rng(seed)
    block = np.cos(np.linspace(0.0, 3.0, t)) + 0.3 * rng.normal(size=(b, r, t))
    mask = np.ones((b, r), bool)
    mask[1, 3] = False  # a padded slot mid-stack
    mask[2, 2:] = False
    block[~mask] = 0.0
    return block, mask


@pytest.mark.parametrize("max_iter,tol,seed", [(6, 1e-4, 7), (50, 1e-3, 0), (3, 0.0, 2)])
def test_subgradient_matches_jax(jax_orders, max_iter, tol, seed):
    block, mask = stacks(seed)
    want, info = jdtw.dba_subgradient_batch(
        jnp.asarray(block), jnp.asarray(mask), max_iter=max_iter, tol=tol, seed=seed,
        return_info=True,
    )
    got, got_info = tdtw.dba_subgradient_batch(
        torch.from_numpy(block), torch.from_numpy(mask), max_iter=max_iter, tol=tol, seed=seed,
        return_info=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert got_info["epochs"] == int(info["epochs"]) <= max_iter
    np.testing.assert_allclose(got_info["cost"].numpy(), np.asarray(info["cost"]), rtol=TOL)
    np.testing.assert_array_equal(got_info["converged"].numpy(), np.asarray(info["converged"]))
    if tol == 0.0:  # nothing converges on tol: the epoch cap ends the loop
        assert got_info["epochs"] == max_iter


def test_subgradient_without_mask_and_info(jax_orders):
    block = np.random.default_rng(3).normal(size=(2, 3, 16))
    want = jdtw.dba_subgradient_batch(jnp.asarray(block), max_iter=4)
    got = tdtw.dba_subgradient_batch(torch.from_numpy(block), max_iter=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_epoch_orders_are_permutations_and_reproducible():
    a = tdtw._epoch_orders(5, 3, 4, 7)
    assert a.shape == (4, 7) and a.dtype == torch.int64
    assert (a.sort(dim=1).values == torch.arange(7)).all()
    assert torch.equal(a, tdtw._epoch_orders(5, 3, 4, 7))
    assert not torch.equal(a, tdtw._epoch_orders(5, 4, 4, 7))


def test_subgradient_single_series_is_fixed_point():
    s = np.random.default_rng(1).normal(size=(1, 1, 20))
    got = tdtw.dba_subgradient_batch(torch.from_numpy(s))
    np.testing.assert_allclose(got[0].numpy(), s[0, 0], atol=1e-12)


@pytest.mark.parametrize("dba_tol", [None, 1e-2])
def test_prepare_gp_inputs_subgradient_matches_jax(jax_orders, dba_tol):
    block, mask = stacks(4)
    jx, jy, jv = jgp.prepare_gp_inputs(jnp.asarray(block), jnp.asarray(mask), dba_iterations=8,
                                       dba_method="subgradient", dba_tol=dba_tol)
    x, y, v = tgp.prepare_gp_inputs(torch.from_numpy(block), torch.from_numpy(mask),
                                    dba_iterations=8, dba_method="subgradient", dba_tol=dba_tol)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-12)
    with pytest.raises(ValueError, match="dba_method"):
        tgp.prepare_gp_inputs(torch.from_numpy(block), torch.from_numpy(mask), dba_method="nope")


def test_multi_scenario_step_subgradient_matches_jax(jax_orders):
    hb, hm, sb, sm, obs = scenario_blocks(11)
    mm = np.ones(hb.shape[:2])
    mm[0, 1] = 0.0
    kw = dict(n_optim_nits=3, dba_iterations=6, dba_method="subgradient")
    want = jstep.ensemble_multi_scenario_step(*(jnp.asarray(a) for a in (hb, hm, sb, sm, obs, mm)), **kw)
    got = tstep.ensemble_multi_scenario_step(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (hb, hm, sb, sm, obs, mm)), **kw
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=STEP_TOL)
