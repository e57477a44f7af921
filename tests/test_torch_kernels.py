"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

Tolerances: the DBA update is an exact DP (identical arithmetic per cell),
so kernel and plain version agree bit for bit.  The linear algebra runs on
Matern-3/2 Grams plus noise (condition number below 1e3); float64 agrees
to 1e-10 and float32 to 1e-3 of the largest entry.
"""

import numpy as np
import pytest
import torch

from bayesian_ensembling_tpu_torch import _build, launch_counts, reset_launch_counts
from bayesian_ensembling_tpu_torch.ops import dtw_cuda
from bayesian_ensembling_tpu_torch.ops import linalg_cuda as tlc

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def make_spd(rng, b, t):
    """Matern-3/2 Grams on sorted 1-D inputs plus noise, as the GP fit sees."""
    x = np.sort(rng.normal(size=(b, t)), axis=1)
    d = np.abs(x[:, :, None] - x[:, None, :]) / 1.3
    k = (1.0 + np.sqrt(3.0) * d) * np.exp(-np.sqrt(3.0) * d)
    return k + rng.uniform(0.05, 0.2, size=(b, t))[:, :, None] * np.eye(t)


def rel_err(got, want):
    got = got.double().cpu()
    want = want.double().cpu()
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


@pytest.mark.parametrize("t", [2, 9, 86, 165])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dba_update_kernel_matches_plain(cuda_device, t, dtype):
    gen = torch.Generator().manual_seed(t)
    c = torch.randn((64, t), generator=gen, dtype=dtype).to(cuda_device)
    s = torch.randn((64, t), generator=gen, dtype=dtype).to(cuda_device)
    reset_launch_counts()
    got_s, got_c = dtw_cuda.dba_update_batch(c, s)
    assert launch_counts()["dba_update"] == 1
    want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_s, want_s)


@pytest.mark.parametrize("t", [1, 13, 86, 165])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
def test_linalg_kernels_match_plain(cuda_device, t, dtype, tol):
    rng = np.random.default_rng(t)
    k = torch.from_numpy(make_spd(rng, 16, t)).to(cuda_device, dtype)
    y = torch.from_numpy(rng.normal(size=(16, t))).to(cuda_device, dtype)
    got = tlc.chol_solve(k, y)
    want = tlc.chol_solve_reference(k, y)
    for g, w in zip(got, want):
        assert rel_err(g, w) < tol
    l = want[0].contiguous()  # torch.linalg returns a column-major factor
    w_got = tlc.tri_inv(l)
    w_want = tlc.tri_inv_reference(l)
    torch.cuda.synchronize()
    assert rel_err(w_got, w_want) < tol


def test_chol_solve_kernel_non_pd_gives_nan(cuda_device):
    rng = np.random.default_rng(0)
    k = make_spd(rng, 3, 20)
    k[1] = -np.eye(20)
    l, z, alpha, logdet = tlc.chol_solve(
        torch.from_numpy(k).to(cuda_device, torch.float32),
        torch.from_numpy(rng.normal(size=(3, 20))).to(cuda_device, torch.float32),
    )
    torch.cuda.synchronize()
    assert torch.isnan(logdet[1]) and torch.isnan(alpha[1]).all()
    assert torch.isfinite(logdet[[0, 2]]).all() and torch.isfinite(alpha[[0, 2]]).all()


def test_kernels_refuse_what_they_lack(cuda_device):
    x = torch.zeros((2, 4, 4), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        tlc.tri_inv(x)
    big = torch.zeros((1, 300, 300), dtype=torch.float32, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        tlc.tri_inv(big)
    with pytest.raises(ValueError, match="contiguous"):
        tlc.tri_inv(torch.zeros((2, 8, 8), device=cuda_device).mT)


def test_library_builds_for_sm90a(cuda_device):
    _build.library()
    assert _build.build_info["path"].endswith(".so")
