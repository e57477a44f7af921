"""The port's squared-DTW cost (the plain version of the cost kernel), the
pairwise costs, the medoid initialisation and the converged (``tol``) DBA,
against the JAX package in float64.

Inputs are made with numpy from a seed.  The DP is exact (comparisons and
one add per cell, in the same order on both sides), so costs agree with the
Pallas kernel in interpret mode and with the JAX scan to 1e-10, and the DBA
barycentres (same medoid, same moves, sums in the same order) to 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import dtw as jdtw
from bayesian_ensembling_tpu.ops import dtw_pallas as jdp
from bayesian_ensembling_tpu_torch import launch_counts, reset_launch_counts
from bayesian_ensembling_tpu_torch.ops import dtw as tdtw
from bayesian_ensembling_tpu_torch.ops import dtw_cuda

torch.set_num_threads(1)

TOL = 1e-10  # exact DP
DBA_TOL = 1e-12  # same medoid, same moves, sums in the same order


def stacks(seed, b=3, r=5, t=14):
    """Ragged stacks of noisy sine series, zero padded."""
    rng = np.random.default_rng(seed)
    block = np.sin(np.linspace(0.0, 3.0, t)) + 0.4 * rng.normal(size=(b, r, t))
    mask = np.ones((b, r), bool)
    mask[0, 3:] = False
    mask[1, 1] = False
    mask[-1, 1:] = False  # a single-series model
    block[~mask] = 0.0
    return block, mask


@pytest.mark.parametrize("t", [1, 2, 9, 21])
def test_cost_matches_pallas_interpret(monkeypatch, t):
    monkeypatch.setattr(jdp, "INTERPRET", True)
    rng = np.random.default_rng(t)
    centers = rng.normal(size=(7, t))
    series = rng.normal(size=(7, t))
    want = jdp.squared_dtw_cost_batch(jnp.asarray(centers), jnp.asarray(series), lanes=128)
    reset_launch_counts()
    got = dtw_cuda.squared_dtw_cost_batch(torch.from_numpy(centers), torch.from_numpy(series))
    assert got.shape == (7,) and got.dtype == torch.float64
    assert launch_counts()["dtw_cost"] == 0  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)


@pytest.mark.parametrize("t", [1, 6, 17])
def test_squared_dtw_and_path_match_jax(t):
    rng = np.random.default_rng(50 + t)
    c, s = rng.normal(size=t), rng.normal(size=t)
    want = float(jdtw.squared_dtw(jnp.asarray(c), jnp.asarray(s)))
    got = tdtw.squared_dtw(torch.from_numpy(c), torch.from_numpy(s))
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=TOL)
    w_total, w_path = jdtw.squared_dtw_with_path(jnp.asarray(c), jnp.asarray(s))
    total, path = tdtw.squared_dtw_with_path(torch.from_numpy(c), torch.from_numpy(s))
    np.testing.assert_allclose(total.item(), float(w_total), rtol=TOL)
    k, i = np.arange(2 * t - 1)[:, None], np.arange(t)[None, :]
    inside = (k - i >= 0) & (k - i < t)
    np.testing.assert_array_equal(path.numpy()[inside], np.asarray(w_path)[inside])


@pytest.mark.parametrize("use_mask", [False, True])
def test_dtw_pairwise_sq_matches_jax(use_mask):
    block, mask = stacks(1)
    series, m = block[1], (mask[1] if use_mask else None)
    want = jdtw.dtw_pairwise_sq(jnp.asarray(series), None if m is None else jnp.asarray(m))
    got = tdtw.dtw_pairwise_sq(torch.from_numpy(series), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)
    assert (got.diagonal() == 0).all() if m is None else np.isinf(got.numpy()[1]).all()
    one = tdtw.dtw_pairwise_sq(torch.from_numpy(series[:1]))
    assert one.shape == (1, 1) and one.item() == 0.0


@pytest.mark.parametrize("init", ["medoid", "mean"])
@pytest.mark.parametrize("tol", [None, 1e-3])
def test_dba_matches_jax(init, tol):
    block, mask = stacks(2)
    series, m = block[0], mask[0]
    want = jdtw.dba(jnp.asarray(series), jnp.asarray(m), n_iterations=4, init=init,
                    tol=None if tol is None else jnp.asarray(tol))
    got = tdtw.dba(torch.from_numpy(series), torch.from_numpy(m), n_iterations=4, init=init,
                   tol=tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=DBA_TOL)


@pytest.mark.parametrize("iterations", [0, 3])
def test_dba_batch_medoid_matches_jax(iterations):
    block, mask = stacks(3)
    want = jdtw.dba_batch(jnp.asarray(block), jnp.asarray(mask), n_iterations=iterations,
                          init="medoid")
    got = tdtw.dba_batch(torch.from_numpy(block), torch.from_numpy(mask),
                         n_iterations=iterations, init="medoid")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=DBA_TOL)
    if iterations == 0:  # the medoid itself is one of the model's valid series
        for b in range(block.shape[0]):
            assert any(np.array_equal(got[b].numpy(), block[b, k])
                       for k in np.flatnonzero(mask[b]))


def test_dba_batch_medoid_single_realisation_axis():
    block = np.random.default_rng(4).normal(size=(3, 1, 14))
    got = tdtw.dba_batch(torch.from_numpy(block), n_iterations=0, init="medoid")
    np.testing.assert_array_equal(got.numpy(), block[:, 0])


@pytest.mark.parametrize("tol", [0.0, 1e-2, 1e-9])
def test_dba_batch_tol_matches_jax(tol):
    block, mask = stacks(5)
    want = jdtw.dba_batch(jnp.asarray(block), jnp.asarray(mask), n_iterations=30,
                          tol=jnp.asarray(tol))
    got = tdtw.dba_batch(torch.from_numpy(block), torch.from_numpy(mask), n_iterations=30,
                         tol=tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=DBA_TOL)
    if tol == 0.0:  # never triggers: the cap acts as the fixed count
        fixed = tdtw.dba_batch(torch.from_numpy(block), torch.from_numpy(mask), n_iterations=30)
        np.testing.assert_array_equal(got.numpy(), fixed.numpy())


def test_cost_wrapper_refuses_what_it_lacks():
    c = torch.zeros((2, 4), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        dtw_cuda.squared_dtw_cost_batch(c, c)
    with pytest.raises(ValueError, match=r"expected two \(N, T\) tensors"):
        dtw_cuda.squared_dtw_cost_batch(torch.zeros((2, 4)), torch.zeros((2, 5)))
    assert dtw_cuda.DTW_COST_T_CAP[torch.float32] >= 1980
    assert dtw_cuda.DTW_COST_T_CAP[torch.float64] >= 1980
