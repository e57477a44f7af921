"""The port's DBA update and classic DBA against the JAX package.

Inputs are made with numpy from a seed and fed to both sides in float64.
The DP is exact (comparisons and one add per cell), so the port's plain
version and the JAX functions agree to round-off: sums and counts are held
at 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import dtw as jdtw
from bayesian_ensembling_tpu.ops import dtw_pallas as jdp
from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops import dtw as tdtw
from bayesian_ensembling_tpu_torch.ops import dtw_cuda

torch.set_num_threads(1)

TOL = 1e-10  # exact DP: identical moves, sums in the same order


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jdp, "INTERPRET", True)


@pytest.mark.parametrize("t", [2, 9, 24, 32])
def test_dba_update_matches_pallas_interpret(pallas_interpret, t):
    rng = np.random.default_rng(t)
    n = 6
    centers = rng.normal(size=(n, t))
    series = rng.normal(size=(n, t))
    want_s, want_c = jdp.dba_update_batch(jnp.asarray(centers), jnp.asarray(series))
    got_s, got_c = dtw_cuda.dba_update_batch(torch.from_numpy(centers), torch.from_numpy(series))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=TOL)


def test_dba_update_t1_special_case():
    c = torch.tensor([[1.0], [2.0]], dtype=torch.float64)
    s = torch.tensor([[3.0], [-1.0]], dtype=torch.float64)
    sums, counts = dtw_cuda.dba_update_batch(c, s)
    want_s, want_c = jdp.dba_update_batch(jnp.asarray(c.numpy()), jnp.asarray(s.numpy()))
    np.testing.assert_array_equal(sums.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("t", [7, 20])
def test_dtw_scan_cost_and_path_match_jax(t):
    rng = np.random.default_rng(100 + t)
    n = 4
    centers = rng.normal(size=(n, t))
    series = rng.normal(size=(n, t))
    total, path = tdtw._dtw_scan(torch.from_numpy(centers), torch.from_numpy(series), True)
    for p in range(n):
        w_total, w_path = jdtw.squared_dtw_with_path(jnp.asarray(centers[p]), jnp.asarray(series[p]))
        np.testing.assert_allclose(total[p].item(), float(w_total), rtol=TOL)
        # Move codes of cells inside the matrix must agree exactly.
        k = np.arange(2 * t - 1)[:, None]
        i = np.arange(t)[None, :]
        inside = (k - i >= 0) & (k - i < t)
        np.testing.assert_array_equal(path[p].numpy()[inside], np.asarray(w_path)[inside])


def test_dba_update_counts_cover_path():
    """Every centre slot is visited, and the visits add up to the path length."""
    rng = np.random.default_rng(3)
    t = 15
    c = torch.from_numpy(rng.normal(size=(5, t)))
    s = torch.from_numpy(rng.normal(size=(5, t)))
    _, counts = dtw_cuda.dba_update_batch(c, s)
    assert (counts >= 1).all()
    total = counts.sum(dim=1)
    assert ((total >= t) & (total <= 2 * t - 1)).all()


@pytest.mark.parametrize("iterations", [1, 3])
def test_dba_batch_matches_jax(iterations):
    rng = np.random.default_rng(iterations)
    b, r, t = 3, 4, 18
    block = rng.normal(size=(b, r, t)) + np.sin(np.linspace(0, 3, t))
    mask = np.ones((b, r), bool)
    mask[0, 3] = False
    mask[2, 1:] = False
    block[~mask] = 0.0
    want = jdtw.dba_batch(jnp.asarray(block), jnp.asarray(mask), n_iterations=iterations)
    got = tdtw.dba_batch(torch.from_numpy(block), torch.from_numpy(mask), n_iterations=iterations)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_dba_batch_refuses_unknown_init():
    block = torch.zeros((1, 2, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown init"):
        tdtw.dba_batch(block, init="nope")


def test_cuda_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device never reaches
    the plain version through the wrapper."""
    c = torch.zeros((2, 4), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        dtw_cuda.dba_update_batch(c, c)


def test_unsupported_dtype_raises():
    with pytest.raises(TypeError, match="float32 or float64"):
        _build.symbol_suffix(torch.float16)
