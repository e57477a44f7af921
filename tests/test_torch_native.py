"""The port's native C++ DTW / DBA engine (``bayesian_ensembling_tpu_torch/
native``) against the port's ``ops/dtw`` plain versions and the JAX
package's ``native``, in float64 on the CPU: the cases of
``tests/test_native.py``, and where the library is built.

Tolerances: the two engines compile one C++ source, so they agree bit for
bit; against ``ops/dtw`` (PyTorch's order of operations) as the JAX native
test holds the JAX kernels: 1e-10 on costs, 1e-8 on barycentres.
"""

import os

import numpy as np
import pytest
import torch

from bayesian_ensembling_tpu import native as jnative
from bayesian_ensembling_tpu_torch import native
from bayesian_ensembling_tpu_torch.ops import dtw as dtw_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not native.available(), reason="native library unavailable (no g++?)")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_library_builds_under_build_native():
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")
    assert os.path.exists(path)
    # nothing is written into the package directory
    pkg = os.path.join(ROOT, "bayesian_ensembling_tpu_torch", "native")
    assert sorted(os.listdir(pkg)) in (["__init__.py", "dtw.cpp"],
                                       ["__init__.py", "__pycache__", "dtw.cpp"])


def test_native_sq_dtw_matches_ops(rng):
    a, b = rng.normal(size=40), rng.normal(size=40)
    got = native.squared_dtw(a, b)
    np.testing.assert_allclose(got, float(dtw_ops.squared_dtw(_t(a), _t(b))), rtol=1e-10)
    assert got == jnative.squared_dtw(a, b)
    with pytest.raises(ValueError, match="equal-length"):
        native.squared_dtw(a, b[:-1])


def test_native_pairwise_matches_ops(rng):
    series = rng.normal(size=(5, 20))
    got = native.dtw_pairwise(series)
    np.testing.assert_allclose(got, dtw_ops.dtw_pairwise_sq(_t(series)).numpy(), rtol=1e-10)
    assert np.allclose(got, got.T)
    np.testing.assert_array_equal(got, jnative.dtw_pairwise(series))


@pytest.mark.parametrize("r,t", [(4, 24), (3, 7), (6, 40)])
def test_native_dba_matches_ops(rng, r, t):
    series = rng.normal(size=(r, t)) + np.sin(np.linspace(0, 3, t))
    got = native.dba(series, n_iterations=5)
    want = dtw_ops.dba(_t(series), n_iterations=5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_array_equal(got, jnative.dba(series, n_iterations=5))


def test_native_dba_constant():
    series = np.tile(np.linspace(0, 1, 15), (3, 1))
    np.testing.assert_allclose(native.dba(series, n_iterations=3), series[0], atol=1e-12)


def test_native_dba_batch_matches_per_model_and_ops(rng):
    """``bet_dba_batch`` (OpenMP over models) equals per-model ``bet_dba``
    exactly, and the port's medoid-init ``dba_batch``."""
    s = rng.normal(size=(5, 4, 30))
    batch = native.dba_batch(s, n_iterations=4)
    solo = np.stack([native.dba(s[i], n_iterations=4) for i in range(5)])
    np.testing.assert_allclose(batch, solo, rtol=1e-14)
    want = dtw_ops.dba_batch(_t(s), n_iterations=4, init="medoid").numpy()
    np.testing.assert_allclose(batch, want, rtol=1e-8)
    np.testing.assert_array_equal(batch, jnative.dba_batch(s, n_iterations=4))


def test_unavailable_engine_raises(monkeypatch):
    """Without a library every entry point raises; ``available`` says so."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    for call in (lambda: native.squared_dtw(np.zeros(3), np.zeros(3)),
                 lambda: native.dtw_pairwise(np.zeros((2, 3))),
                 lambda: native.dba(np.zeros((2, 3))),
                 lambda: native.dba_batch(np.zeros((1, 2, 3)))):
        with pytest.raises(RuntimeError, match="unavailable"):
            call()
