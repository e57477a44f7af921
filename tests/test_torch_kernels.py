"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

Tolerances: the DBA updates and the squared-DTW cost are an exact DP
(identical arithmetic per cell), so the kernels and the plain versions agree
bit for bit.  The linear
algebra runs on Matern-3/2 Grams plus noise (condition number below 1e3);
float64 agrees to 1e-10 and float32 to 1e-3 of the largest entry.
"""

import numpy as np
import pytest
import torch

from bayesian_ensembling_tpu_torch import _build, launch_counts, reset_launch_counts, route_counts
from bayesian_ensembling_tpu_torch.ops import dtw_cuda
from bayesian_ensembling_tpu_torch.ops import linalg_blocked as tlb
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


@pytest.mark.parametrize("t", [2, 9, 165, 1032])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dba_update_split_kernel_matches_plain(cuda_device, t, dtype):
    gen = torch.Generator().manual_seed(t)
    c = torch.randn((16, t), generator=gen, dtype=dtype).to(cuda_device)
    s = torch.randn((16, t), generator=gen, dtype=dtype).to(cuda_device)
    reset_launch_counts()
    got_s, got_c = dtw_cuda.dba_update_batch(c, s, impl="split")
    assert launch_counts()["dba_update_split"] == 1 and launch_counts()["dba_update"] == 0
    want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_s, want_s)
    if dtw_cuda.fused_dba_fits(t, dtype):
        fused = dtw_cuda.dba_update_batch(c, s, impl="fused")
        assert torch.equal(fused[0], got_s) and torch.equal(fused[1], got_c)


def test_dba_update_split_chunks_its_scratch(cuda_device, monkeypatch):
    t = 40
    monkeypatch.setattr(dtw_cuda, "SPLIT_SCRATCH_BYTES", 3 * (2 * t - 1) * t)
    gen = torch.Generator().manual_seed(5)
    c = torch.randn((10, t), generator=gen).to(cuda_device)
    s = torch.randn((10, t), generator=gen).to(cuda_device)
    reset_launch_counts()
    got = dtw_cuda.dba_update_batch(c, s, impl="split")
    assert launch_counts()["dba_update_split"] == 4  # 3 + 3 + 3 + 1 pairs
    want = dtw_cuda.dba_update_batch_reference(c, s)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("t", [1, 13, 128, 169])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
def test_chol_kernel_matches_plain(cuda_device, t, dtype, tol):
    rng = np.random.default_rng(100 + t)
    k = torch.from_numpy(make_spd(rng, 16, t)).to(cuda_device, dtype)
    reset_launch_counts()
    got = tlc.chol(k)
    assert launch_counts()["chol"] == 1
    want = tlc.chol_reference(k)
    torch.cuda.synchronize()
    assert rel_err(got, want) < tol
    assert (got.triu(1) == 0).all()


def test_chol_kernel_non_pd_gives_nan(cuda_device):
    rng = np.random.default_rng(2)
    k = make_spd(rng, 4, 128)
    k[2] = -np.eye(128)
    l = tlc.chol(torch.from_numpy(k).to(cuda_device, torch.float32))
    torch.cuda.synchronize()
    assert torch.isnan(l[2].diagonal()).all()
    assert torch.isfinite(l[[0, 1, 3]]).all()


def test_blocked_nlml_f32_kernels_match_library_f64(cuda_device):
    """The blocked NLML on the Cholesky and triangular-inverse kernels in
    float32 against torch.linalg in float64: relative error below 1e-3 in
    values and gradients (float32 round-off on conditioned Grams)."""
    rng = np.random.default_rng(9)
    b, t = 6, 300
    k = make_spd(rng, b, t)
    y = rng.normal(size=(b, t))
    k32 = torch.from_numpy(k).to(cuda_device, torch.float32).requires_grad_(True)
    y32 = torch.from_numpy(y).to(cuda_device, torch.float32).requires_grad_(True)
    reset_launch_counts()
    q, ld = tlb.nlml_terms_blocked(k32, y32)
    g_k, g_y = torch.autograd.grad((q + ld).sum(), (k32, y32))
    # 300 pads to 384 = 3 leaves of 128.
    assert launch_counts()["chol"] == 3 and launch_counts()["tri_inv"] == 3
    k64 = torch.from_numpy(k).to(cuda_device).requires_grad_(True)
    y64 = torch.from_numpy(y).to(cuda_device).requires_grad_(True)
    q64, ld64 = tlc.nlml_terms(k64, y64)  # T = 300 is beyond the float64 cap: torch.linalg
    w_k, w_y = torch.autograd.grad((q64 + ld64).sum(), (k64, y64))
    assert route_counts() == {"kernel": 0, "blocked": 1, "library": 2}
    for got, want in ((q, q64), (ld, ld64), (g_k, w_k), (g_y, w_y)):
        assert rel_err(got, want) < 1e-3


def test_kernels_refuse_what_they_lack(cuda_device):
    x = torch.zeros((2, 4, 4), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        tlc.tri_inv(x)
    big = torch.zeros((1, 300, 300), dtype=torch.float32, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        tlc.tri_inv(big)
    with pytest.raises(ValueError, match="contiguous"):
        tlc.tri_inv(torch.zeros((2, 8, 8), device=cuda_device).mT)
    with pytest.raises(RuntimeError, match="launch failed"):
        tlc.chol(torch.zeros((1, 241, 241), dtype=torch.float32, device=cuda_device))
    with pytest.raises(ValueError, match="impl='split'"):
        dtw_cuda.dba_update_batch(torch.zeros((2, 500), device=cuda_device),
                                  torch.zeros((2, 500), device=cuda_device), impl="fused")
    big_t = dtw_cuda.DTW_COST_T_CAP[torch.float64] + 1
    with pytest.raises(ValueError, match="shared-memory cap"):
        dtw_cuda.squared_dtw_cost_batch(torch.zeros((1, big_t), dtype=torch.float64, device=cuda_device),
                                        torch.zeros((1, big_t), dtype=torch.float64, device=cuda_device))


@pytest.mark.parametrize("t", [1, 2, 165, 1980])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dtw_cost_kernel_matches_plain(cuda_device, t, dtype):
    """N = 37 pairs fill no whole wave of blocks; T = 1980 strides rows over
    the block's 512 threads."""
    gen = torch.Generator().manual_seed(t)
    c = torch.randn((37, t), generator=gen, dtype=dtype).to(cuda_device)
    s = torch.randn((37, t), generator=gen, dtype=dtype).to(cuda_device)
    reset_launch_counts()
    got = dtw_cuda.squared_dtw_cost_batch(c, s)
    assert launch_counts()["dtw_cost"] == 1
    want = dtw_cuda.squared_dtw_cost_batch_reference(c, s)
    torch.cuda.synchronize()
    assert got.shape == (37,) and got.dtype == dtype
    assert torch.equal(got, want)


def test_dtw_cost_kernel_serves_the_medoid_and_subgradient_paths(cuda_device):
    """The medoid init makes one cost launch for all B*R(R-1)/2 pairs; the
    subgradient DBA makes one per epoch and R DBA-update launches per
    epoch; both equal their CPU runs (the epoch orders are drawn on the
    CPU, so the two take the same orders)."""
    from bayesian_ensembling_tpu_torch.ops import dtw as tdtw

    gen = torch.Generator().manual_seed(3)
    block = torch.randn((4, 6, 40), generator=gen, dtype=torch.float64)
    mask = torch.ones((4, 6), dtype=torch.bool)
    mask[1, 4:] = False
    reset_launch_counts()
    got = tdtw.dba_batch(block.to(cuda_device), mask.to(cuda_device), n_iterations=2, init="medoid")
    assert launch_counts()["dtw_cost"] == 1 and launch_counts()["dba_update"] == 2
    want = tdtw.dba_batch(block, mask, n_iterations=2, init="medoid")
    # Exact DP on both sides; the masked sums over R may differ in order.
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-12)
    reset_launch_counts()
    got, info = tdtw.dba_subgradient_batch(block.to(cuda_device), mask.to(cuda_device),
                                           max_iter=5, return_info=True)
    assert launch_counts()["dtw_cost"] == info["epochs"]
    assert launch_counts()["dba_update"] == 6 * info["epochs"]
    want = tdtw.dba_subgradient_batch(block, mask, max_iter=5)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-12)


def test_library_builds_for_sm90a(cuda_device):
    _build.library()
    assert _build.build_info["path"].endswith(".so")
