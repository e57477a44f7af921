"""The port's split DBA update against the JAX package's split kernel pair in
Pallas interpret mode, and the DBA impl gates.

Inputs are made with numpy from a seed and fed to both sides in float64.
The DP is exact (comparisons and one add per cell, summed in the same
order), so counts must be equal and sums agree to 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import dtw_pallas as jdp
from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops import dtw as tdtw
from bayesian_ensembling_tpu_torch.ops import dtw_cuda

torch.set_num_threads(1)

TOL = 1e-10


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jdp, "INTERPRET", True)


@pytest.mark.parametrize("t", [9, 24, 165])
def test_dba_update_split_matches_pallas_interpret(pallas_interpret, t):
    rng = np.random.default_rng(40 + t)
    n = 5
    centers = rng.normal(size=(n, t))
    series = rng.normal(size=(n, t))
    want_s, want_c = jdp.dba_update_batch(jnp.asarray(centers), jnp.asarray(series), impl="split")
    got_s, got_c = dtw_cuda.dba_update_batch(
        torch.from_numpy(centers), torch.from_numpy(series), impl="split"
    )
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=TOL)


@pytest.mark.parametrize(
    ("t", "dtype", "fused", "split"),
    [
        (165, torch.float32, True, True),  # annual
        (474, torch.float32, True, True),  # the fused kernel's float32 cap
        (475, torch.float32, False, True),
        (466, torch.float64, True, True),  # its float64 cap
        (467, torch.float64, False, True),
        (1032, torch.float32, False, True),  # monthly SSP: split through "auto"
        (1980, torch.float32, False, True),  # monthly historical
        (1980, torch.float64, False, True),  # the f64 reference run
        (11621, torch.float32, False, True),  # the split kernel's float32 cap
        (11622, torch.float32, False, False),
        (5811, torch.float64, False, False),
    ],
)
def test_dba_kernel_gates(t, dtype, fused, split):
    assert dtw_cuda.fused_dba_fits(t, dtype) is fused
    assert dtw_cuda.split_dba_fits(t, dtype) is split


def test_dba_caps_are_the_launchers_shared_memory():
    for dtype in (torch.float32, torch.float64):
        e = dtype.itemsize
        cap = dtw_cuda.SPLIT_DBA_T_CAP[dtype]
        assert dtw_cuda._split_smem_bytes(cap, e) <= _build.SMEM_BYTES < dtw_cuda._split_smem_bytes(cap + 1, e)
        cap = dtw_cuda.FUSED_DBA_T_CAP[dtype]
        assert dtw_cuda._fused_smem_bytes(cap, e) <= _build.SMEM_BYTES < dtw_cuda._fused_smem_bytes(cap + 1, e)


def test_dba_update_impl_errors():
    small = torch.zeros((2, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown impl"):
        dtw_cuda.dba_update_batch(small, small, impl="scan")
    mid = torch.zeros((1, 500), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"fused DBA kernel.*needs \d+ bytes"):
        dtw_cuda.dba_update_batch(mid, mid, impl="fused")
    huge = torch.zeros((1, 6000), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"split DBA kernel.*needs 240024 bytes"):
        dtw_cuda.dba_update_batch(huge, huge)
    with pytest.raises(TypeError, match="float32 or float64"):
        dtw_cuda.dba_update_batch(small.half(), small.half())


def test_dba_batch_split_and_fused_agree(monkeypatch):
    """dba_batch through the split route (fused gate closed) equals the
    default route: both are the same function."""
    rng = np.random.default_rng(8)
    block = torch.from_numpy(rng.normal(size=(3, 4, 30)))
    mask = torch.from_numpy(np.array([[1, 1, 1, 0], [1, 0, 0, 0], [1, 1, 1, 1]], bool))
    want = tdtw.dba_batch(block, mask, n_iterations=3)
    seen = []
    real = dtw_cuda.dba_update_batch

    def spy(c, s, impl="auto"):
        seen.append(impl)
        return real(c, s, impl="split")

    monkeypatch.setattr(dtw_cuda, "dba_update_batch", spy)
    got = tdtw.dba_batch(block, mask, n_iterations=3)
    assert seen == ["auto"] * 3
    np.testing.assert_array_equal(got.numpy(), want.numpy())
