"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

Tolerances: the DBA updates and the squared-DTW cost are an exact DP
(identical arithmetic per cell), so the kernels and the plain versions agree
bit for bit.  The linear
algebra runs on Matern-3/2 Grams plus noise (condition number below 1e3);
float64 agrees to 1e-10 and float32 to 1e-3 of the largest entry.  The
blocked NLML at the monthly campaign's shapes runs on the campaign's own
Grams, worse conditioned, at 1e-2.  The Matern-3/2 Gram kernel equals
PyTorch's elementwise chain bit for bit; its gradient's contraction agrees
with autograd of the chain to 1e-13 in float64, and in float32 with
float64 to 3e-7, each relative to the sum of the terms' absolute values,
limits that the same contraction with its terms rounded to float32 (or
bfloat16) misses.
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


# Band edges of csrc/dtw_band.cuh (31 / 32 / 33 rows, 64 / 65), the annual
# T = 86 and 165, the cap of byte-wide codes (474) and the fused cap; N = 112
# is the subgradient DBA's launch, 3,248 the classic DBA's (T <= 165 there:
# the plain version's move codes take N (2T - 1) T bytes).
DBA_SIZES = [1, 2, 9, 31, 32, 33, 64, 65, 86, 165, 474, "cap"]


def _dba_t(t, dtype):
    return dtw_cuda.FUSED_DBA_T_CAP[dtype] if t == "cap" else t


def _dba_pairs(n, t, dtype, device, kind="random"):
    gen = torch.Generator().manual_seed(t)
    if kind == "constant":  # every comparison a tie
        return (torch.full((n, t), 0.5, dtype=dtype, device=device),
                torch.full((n, t), -0.25, dtype=dtype, device=device))
    return (torch.randn((n, t), generator=gen, dtype=dtype).to(device),
            torch.randn((n, t), generator=gen, dtype=dtype).to(device))


@pytest.mark.parametrize("n,t", [(n, t) for n in (112, 3248) for t in DBA_SIZES
                                 if n == 112 or t not in (474, "cap")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dba_update_kernel_matches_plain(cuda_device, t, dtype, n):
    t = _dba_t(t, dtype)
    c, s = _dba_pairs(n, t, dtype, cuda_device)
    reset_launch_counts()
    got_s, got_c = dtw_cuda.dba_update_batch(c, s, impl="fused")
    assert launch_counts()["dba_update"] == (t > 1)
    want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_s, want_s)


@pytest.mark.parametrize("kind", ["nan", "constant"])
@pytest.mark.parametrize("t", [2, 33, 86, 165])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dba_update_kernel_nan_and_ties(cuda_device, t, dtype, kind):
    """A NaN in one series (the path past it ends where the plain version's
    does) and constant series (all ties), at both layouts."""
    for n in (112, 3248):
        c, s = _dba_pairs(n, t, dtype, cuda_device, "constant" if kind == "constant" else "random")
        if kind == "nan":
            s[7, t // 2] = float("nan")
        got_s, got_c = dtw_cuda.dba_update_batch(c, s)
        want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
        torch.cuda.synchronize()
        assert torch.equal(got_c, want_c)
        assert torch.equal(got_s.isnan(), want_s.isnan())
        assert torch.equal(got_s.nan_to_num(), want_s.nan_to_num())


@pytest.mark.parametrize("h", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("t", [2, 33, 86, 165])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dba_update_kernel_every_band_height(cuda_device, t, dtype, h):
    """Every built height, one pair a block and four, several warps a pair
    at the small heights; the launcher refuses a height it lacks."""
    c, s = _dba_pairs(40, t, dtype, cuda_device)
    want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
    for ppb in (1, 4):
        if 32 * -(-(-(-t // h)) // 32) * ppb > 512:
            continue
        got_s, got_c = torch.empty_like(c), torch.empty_like(c)
        dtw_cuda._launch_fused(c, s, got_s, got_c, h, ppb)
        torch.cuda.synchronize()
        assert torch.equal(got_c, want_c) and torch.equal(got_s, want_s)
    with pytest.raises(RuntimeError, match="launch failed"):
        dtw_cuda._launch_fused(c, s, got_s, got_c, 3, 1)


@pytest.mark.parametrize("n", [64, 812])
def test_dba_update_fused_equals_split_at_720(cuda_device, n):
    """Past the cap of byte-wide codes the fused kernel takes T = 720, equal
    to the split kernel and the plain version in both dtypes (N = 812: a
    monthly historical chunk's pairs)."""
    for dtype in (torch.float32, torch.float64):
        c, s = _dba_pairs(n, 720, dtype, cuda_device)
        fused = dtw_cuda.dba_update_batch(c, s, impl="fused")
        split = dtw_cuda.dba_update_batch(c, s, impl="split")
        want = dtw_cuda.dba_update_batch_reference(c, s)
        torch.cuda.synchronize()
        for got in (fused, split):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# The panel designs' edges: one column, one short panel, one row short of a
# panel, a whole panel, one row over, whole and ragged multiples, and the
# largest T the shared memory takes (239 in float32, 168 in float64).
PANEL_SIZES = [1, 2, 13, 31, 32, 33, 64, 86, 128, 165, "cap"]


def _size(t, dtype):
    return tlc.KERNEL_T_CAP[dtype] if t == "cap" else t


@pytest.mark.parametrize("b", [1, 16, 65, 112, 200])
@pytest.mark.parametrize("t", PANEL_SIZES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
def test_linalg_kernels_match_plain(cuda_device, t, dtype, tol, b):
    t = _size(t, dtype)
    rng = np.random.default_rng(t)
    k = torch.from_numpy(make_spd(rng, b, t)).to(cuda_device, dtype)
    y = torch.from_numpy(rng.normal(size=(b, t))).to(cuda_device, dtype)
    got = tlc.chol_solve(k, y)
    want = tlc.chol_solve_reference(k, y)
    for g, w in zip(got, want):
        assert rel_err(g, w) < tol
    l = want[0].contiguous()  # torch.linalg returns a column-major factor
    w_got = tlc.tri_inv(l)
    w_want = tlc.tri_inv_reference(l)
    torch.cuda.synchronize()
    assert rel_err(w_got, w_want) < tol
    assert (w_got.triu(1) == 0).all() and (got[0].triu(1) == 0).all()


def _with_bad_pivot(rng, t, column):
    """Three Grams; the middle one gets a non-positive pivot at ``column``."""
    k = make_spd(rng, 3, t)
    k[1, column, column] = -1.0
    return k


def _nan_from_column(l, column):
    """Entries of the lower triangle are NaN from ``column`` on and finite
    before it."""
    t = l.shape[-1]
    low = torch.tril(torch.ones((t, t), dtype=torch.bool, device=l.device))
    late = low & (torch.arange(t, device=l.device)[None, :] >= column)
    return bool(torch.isnan(l[late]).all() and torch.isfinite(l[low & ~late]).all())


# A non-positive pivot in the first, a middle and the (ragged) last panel.
BAD_PIVOTS = [(86, 5), (86, 40), (86, 85), (165, 0), (165, 100), (165, 164)]


@pytest.mark.parametrize("t,column", BAD_PIVOTS + [(86, 0)])
def test_chol_solve_kernel_non_pd_gives_nan(cuda_device, t, column):
    rng = np.random.default_rng(column)
    l, z, alpha, logdet = tlc.chol_solve(
        torch.from_numpy(_with_bad_pivot(rng, t, column)).to(cuda_device, torch.float32),
        torch.from_numpy(rng.normal(size=(3, t))).to(cuda_device, torch.float32),
    )
    torch.cuda.synchronize()
    assert _nan_from_column(l[1], column)
    assert torch.isnan(z[1, column:]).all() and torch.isfinite(z[1, :column]).all()
    assert torch.isnan(logdet[1]) and torch.isnan(alpha[1]).all()
    assert torch.isfinite(logdet[[0, 2]]).all() and torch.isfinite(alpha[[0, 2]]).all()
    assert torch.isfinite(l[[0, 2]]).all() and torch.isfinite(z[[0, 2]]).all()


# 1032 and 1980: the monthly shapes (17 and 31 bands of 64 rows, one warp);
# 2049 and 4500: two and three warps a pair, handing rows over in shared memory.
# N = 16 pairs, then the paths' batches: the annual classic DBA's 3,248 pairs
# at T = 165, the monthly SSP fit's 1,885 at T = 1032 and a historical
# chunk's 812 at T = 1980.
SPLIT_SIZES = [(16, t) for t in (2, 9, 165, 1032, 1980, 2049, 4500)] + [
    (3248, 165), (1885, 1032), (812, 1980)]


@pytest.mark.parametrize("n,t", SPLIT_SIZES,
                         ids=[str(t) if n == 16 else f"{n}x{t}" for n, t in SPLIT_SIZES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dba_update_split_kernel_matches_plain(cuda_device, n, t, dtype):
    gen = torch.Generator().manual_seed(t)
    c = torch.randn((n, t), generator=gen, dtype=dtype).to(cuda_device)
    s = torch.randn((n, t), generator=gen, dtype=dtype).to(cuda_device)
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


@pytest.mark.parametrize("t", [2, 33, 165, 1032, 1980, 2049])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dba_update_split_kernel_after_a_nan(cuda_device, t, dtype):
    """A NaN in row 0 of one centre (the walk leaves the matrix at
    (0, T-1) and ends there), in one series and in the middle of another
    centre: sums and counts equal the plain version's, NaN for NaN, and
    equal the fused kernel's where it fits."""
    c, s = _dba_pairs(16, t, dtype, cuda_device)
    c[1, 0] = float("nan")
    s[7, t // 3] = float("nan")
    c[9, t // 2] = float("nan")
    got_s, got_c = dtw_cuda.dba_update_batch(c, s, impl="split")
    want_s, want_c = dtw_cuda.dba_update_batch_reference(c, s)
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_s.isnan(), want_s.isnan())
    assert torch.equal(got_s.nan_to_num(), want_s.nan_to_num())
    assert torch.equal(got_c[1], torch.ones(t, dtype=dtype, device=cuda_device))
    if dtw_cuda.fused_dba_fits(t, dtype):
        fused_s, fused_c = dtw_cuda.dba_update_batch(c, s, impl="fused")
        assert torch.equal(fused_c, got_c) and torch.equal(fused_s.nan_to_num(), got_s.nan_to_num())


def test_dba_update_split_chunks_its_scratch(cuda_device, monkeypatch):
    t = 40
    monkeypatch.setattr(dtw_cuda, "SPLIT_SCRATCH_BYTES", 3 * dtw_cuda._split_scratch_bytes(t))
    gen = torch.Generator().manual_seed(5)
    c = torch.randn((10, t), generator=gen).to(cuda_device)
    s = torch.randn((10, t), generator=gen).to(cuda_device)
    reset_launch_counts()
    got = dtw_cuda.dba_update_batch(c, s, impl="split")
    assert launch_counts()["dba_update_split"] == 4  # 3 + 3 + 3 + 1 pairs
    want = dtw_cuda.dba_update_batch_reference(c, s)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b", [1, 16, 65, 200])
@pytest.mark.parametrize("t", PANEL_SIZES + [169, 170])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
def test_chol_kernel_matches_plain(cuda_device, t, dtype, tol, b):
    """T = 170 is the largest the Cholesky kernel alone takes in float64."""
    t = _size(t, dtype)
    rng = np.random.default_rng(100 + t)
    k = torch.from_numpy(make_spd(rng, b, t)).to(cuda_device, dtype)
    reset_launch_counts()
    got = tlc.chol(k)
    assert launch_counts()["chol"] == 1
    want = tlc.chol_reference(k)
    torch.cuda.synchronize()
    assert rel_err(got, want) < tol
    assert (got.triu(1) == 0).all()


@pytest.mark.parametrize("t,column", BAD_PIVOTS + [(128, 0)])
def test_chol_kernel_non_pd_gives_nan(cuda_device, t, column):
    rng = np.random.default_rng(2 + column)
    l = tlc.chol(torch.from_numpy(_with_bad_pivot(rng, t, column)).to(cuda_device, torch.float32))
    torch.cuda.synchronize()
    assert _nan_from_column(l[1], column)
    assert torch.isfinite(l[[0, 2]]).all()


def _monthly_gram(b, t, device):
    """Matern-3/2 Grams (lengthscale 1, variance 1) in float32 of the monthly
    campaign's realisations at each month, plus noise of 0.005 to 0.05: the
    SSP fit's 65 models at T = 1032, or a historical chunk's 28 (the 20
    unique models and 8 repeats) at T = 1980, as ``chip_smoke.py`` packs
    them from the benchmark's generator (seed 0).  Worse conditioned than
    ``make_spd``'s: smaller noise, and the padded realisations are zeros."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
    from bayesian_ensembling_tpu_torch.parallel.campaign import pad_unique_axis

    pack, _ = chip_smoke.monthly_campaign(0)
    block = pack.usb if t == pack.usb.shape[-1] else pad_unique_axis(pack.uh, pack.um, b)[0]
    assert block.shape[0] == b and block.shape[-1] == t
    x = torch.from_numpy(block).to(device, torch.float32).transpose(1, 2).contiguous()
    noise = np.random.default_rng(3).uniform(0.005, 0.05, (b, t))
    with torch.no_grad():
        k = gp_ops.matern32(gp_ops.init_params(b, device=device, dtype=torch.float32), x, x)
    return k + torch.diag_embed(torch.from_numpy(noise).to(device, torch.float32))


# The monthly campaign's SSP fit (65, 1032) and historical chunk (28, 1980),
# on its Grams, at 1e-2: float32 round-off of the Cholesky of a Gram whose
# condition number grows with T.
@pytest.mark.parametrize("b,t,tol", [(6, 300, 1e-3), (65, 1032, 1e-2), (28, 1980, 1e-2)])
def test_blocked_nlml_f32_kernels_match_library_f64(cuda_device, b, t, tol):
    """The blocked NLML on the Cholesky and triangular-inverse kernels in
    float32 against torch.linalg in float64: relative error below ``tol``
    in values and gradients (float32 round-off on conditioned Grams)."""
    rng = np.random.default_rng(9)
    if t > 1000:
        k = _monthly_gram(b, t, cuda_device)
    else:
        k = torch.from_numpy(make_spd(rng, b, t)).to(cuda_device)
    y = rng.normal(size=(b, t))
    k32 = k.detach().to(torch.float32).requires_grad_(True)
    y32 = torch.from_numpy(y).to(cuda_device, torch.float32).requires_grad_(True)
    reset_launch_counts()
    q, ld = tlb.nlml_terms_blocked(k32, y32)
    g_k, g_y = torch.autograd.grad((q + ld).sum(), (k32, y32))
    # 300 pads to 384 = 3 leaves of 128; 1032 to 9, 1980 to 16.
    leaves = -(-t // tlb.DEFAULT_BLOCK)
    assert launch_counts()["chol"] == leaves and launch_counts()["tri_inv"] == leaves
    k64 = k.detach().to(torch.float64).requires_grad_(True)
    y64 = torch.from_numpy(y).to(cuda_device).requires_grad_(True)
    q64, ld64 = tlc.nlml_terms(k64, y64)  # T is beyond the float64 cap: torch.linalg
    w_k, w_y = torch.autograd.grad((q64 + ld64).sum(), (k64, y64))
    assert route_counts() == {"kernel": 0, "blocked": 1, "library": 2}
    for got, want in ((q, q64), (ld, ld64), (g_k, w_k), (g_y, w_y)):
        assert rel_err(got, want) < tol


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
        dtw_cuda.dba_update_batch(torch.zeros((2, 1000), device=cuda_device),
                                  torch.zeros((2, 1000), device=cuda_device), impl="fused")
    big_t = dtw_cuda.DTW_COST_T_CAP[torch.float64] + 1
    with pytest.raises(ValueError, match="cost kernel's cap"):
        dtw_cuda.squared_dtw_cost_batch(torch.zeros((1, big_t), dtype=torch.float64, device=cuda_device),
                                        torch.zeros((1, big_t), dtype=torch.float64, device=cuda_device))


@pytest.mark.parametrize("t", [1, 2, 31, 32, 33, 64, 65, 86, 165, 474, 513, 1024, 1025, 1032, 1980, 2049, 4500])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dtw_cost_kernel_matches_plain(cuda_device, t, dtype):
    """N = 37 pairs fill no whole block of four; past T = 1,024 in float32
    and 512 in float64 a pair takes several warps handing rows on through
    shared memory (T = 1980: 2 / 4)."""
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


# (N, T): the subgradient epoch's N = 3,248 and a small N up to the cap (16
# warps a pair); the medoid init's 45,472 pairs at T = 165 and a monthly
# historical chunk's 812 at T = 1980.
COST_PATH_SIZES = [(n, t) for n in (112, 3248) for t in (1, 2, 33, 86, 165, "cap")] + [
    (45472, 165), (812, 1980)]


@pytest.mark.parametrize("n,t", COST_PATH_SIZES, ids=[f"{t}-{n}" for n, t in COST_PATH_SIZES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dtw_cost_kernel_at_the_path_sizes(cuda_device, t, dtype, n):
    """The paths' sizes; a NaN in one series and constant series (ties):
    the kernel's 3e38 sentinel stands where the plain version's +inf
    leaks."""
    t = dtw_cuda.DTW_COST_T_CAP[dtype] if t == "cap" else t
    if t > 4500:
        n = 4
    for kind in ("random", "constant", "nan"):
        c, s = _dba_pairs(n, t, dtype, cuda_device, "constant" if kind == "constant" else "random")
        if kind == "nan":
            s[3, t // 2] = float("nan")
        got = dtw_cuda.squared_dtw_cost_batch(c, s)
        want = dtw_cuda.squared_dtw_cost_batch_reference(c, s)
        want = torch.where(want > 3.0e38, torch.tensor(3.0e38, dtype=dtype, device=cuda_device), want)
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


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


@pytest.mark.parametrize("b,t", [(1, 1), (3, 31), (16, 33), (16, 86), (16, 165), (5, 1032),
                                 (112, 165)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
def test_solve_vec_kernel_matches_plain(cuda_device, b, t, dtype, tol):
    """T = 31 / 33 straddle one 32-row panel; T = 1032 is 33 panels with a
    partial last one; (112, 165) is the annual step's batch."""
    rng = np.random.default_rng(200 + t)
    k = torch.from_numpy(make_spd(rng, b, t)).to(cuda_device, dtype)
    y = torch.from_numpy(rng.normal(size=(b, t))).to(cuda_device, dtype)
    l = tlc.chol_reference(k).contiguous()
    reset_launch_counts()
    got = tlc.solve_vec(l, y)
    assert launch_counts()["solve_vec"] == 1
    want = tlc.solve_vec_reference(l, y)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_err(g, w) < tol
    # The JAX-layout wrapper is the same kernel behind two transposes.
    zt, at, ld = tlc.solve_vec_batched(l.permute(2, 1, 0), y.T)
    assert torch.equal(zt.T, got[0]) and torch.equal(at.T, got[1]) and torch.equal(ld, got[2])


@pytest.mark.parametrize("b", [16, 112])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
def test_chol_then_solve_vec_equals_fused_kernel(cuda_device, dtype, tol, b):
    rng = np.random.default_rng(7)
    k = torch.from_numpy(make_spd(rng, b, 165)).to(cuda_device, dtype)
    y = torch.from_numpy(rng.normal(size=(b, 165))).to(cuda_device, dtype)
    reset_launch_counts()
    got = tlc.chol_solve_composed(k, y)
    assert launch_counts()["chol"] == 1 and launch_counts()["solve_vec"] == 1
    want = tlc.chol_solve(k, y)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert rel_err(g, w) < tol


def test_solve_vec_kernel_bad_diagonal_is_not_trapped(cuda_device):
    """A zero diagonal entry gives non-finite z / alpha and -inf logdet, a
    negative one NaN logdet, in that matrix only (as the plain version)."""
    rng = np.random.default_rng(4)
    l = np.linalg.cholesky(make_spd(rng, 4, 40))
    l[1, 10, 10] = 0.0
    l[2, 39, 39] = -1.0
    l_t = torch.from_numpy(l).to(cuda_device, torch.float32)
    y = torch.from_numpy(rng.normal(size=(4, 40))).to(cuda_device, torch.float32)
    z, alpha, logdet = tlc.solve_vec(l_t, y)
    torch.cuda.synchronize()
    assert logdet[1] == -float("inf") and not torch.isfinite(z[1]).all()
    assert not torch.isfinite(alpha[1]).all()
    assert torch.isnan(logdet[2]) and torch.isfinite(z[2]).all()
    for out in (z, alpha, logdet):
        assert torch.isfinite(out[[0, 3]]).all()
    z_ref, _, ld_ref = tlc.solve_vec_reference(l_t, y)
    assert ld_ref[1] == -float("inf") and torch.isnan(ld_ref[2])
    assert rel_err(z[[0, 2, 3]], z_ref[[0, 2, 3]]) < 1e-3


def _solve_vec_inputs(b, t, dtype, device, seed=0):
    rng = np.random.default_rng(300 + 7 * t + seed)
    l = np.linalg.cholesky(make_spd(rng, b, t))
    y = rng.normal(size=(b, t))
    return (torch.from_numpy(l).to(device, dtype).contiguous(),
            torch.from_numpy(y).to(device, dtype))


def _force_layout(monkeypatch, layout):
    """The wrapper picks the layout from SOLVE_VEC_RESIDENT_T_CAP: 0 sends
    every T to the streamed layout."""
    if layout == "streamed":
        monkeypatch.setattr(tlc, "SOLVE_VEC_RESIDENT_T_CAP", {torch.float32: 0, torch.float64: 0})


# Panel edges (31 / 32 / 33), the library's T = 86 / 165, the resident caps
# and one past them, and the monthly T; the streamed layout at every size,
# so that its single-chunk, ragged and multi-chunk panels all run.
SOLVE_VEC_SIZES = [1, 2, 31, 32, 33, 86, 165, "cap", "cap+1", 1032]


@pytest.mark.parametrize("layout", ["auto", "streamed"])
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("t", SOLVE_VEC_SIZES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
def test_solve_vec_kernel_layouts_and_forward_only(cuda_device, monkeypatch, layout, b, t, dtype, tol):
    """Both layouts against the plain version; the forward-only launch's z
    and logdet equal the full launch's bit for bit; one launch each."""
    cap = tlc.SOLVE_VEC_RESIDENT_T_CAP[dtype]
    t = {"cap": cap, "cap+1": cap + 1}.get(t, t)
    _force_layout(monkeypatch, layout)
    l, y = _solve_vec_inputs(b, t, dtype, cuda_device)
    reset_launch_counts()
    got = tlc.solve_vec(l, y)
    fwd = tlc.solve_vec_forward(l, y)
    assert launch_counts()["solve_vec"] == 2
    want = tlc.solve_vec_reference(l, y)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_err(g, w) < tol
    assert torch.equal(fwd[0], got[0]) and torch.equal(fwd[1], got[2])


@pytest.mark.parametrize("b,t", [(2, 1980), (1, 4500), (65, 1032), (28, 1980)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
def test_solve_vec_kernel_streams_large_t(cuda_device, b, t, dtype, tol):
    """Past the resident cap: the monthly T = 1980 and 4,500 (141 panels,
    the ring turned over many times), and the monthly campaign's batches."""
    l, y = _solve_vec_inputs(b, t, dtype, cuda_device)
    got = tlc.solve_vec(l, y)
    fwd = tlc.solve_vec_forward(l, y)
    want = tlc.solve_vec_reference(l, y)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert rel_err(g, w) < tol
    assert torch.equal(fwd[0], got[0]) and torch.equal(fwd[1], got[2])


@pytest.mark.parametrize("layout", ["auto", "streamed"])
@pytest.mark.parametrize("t", [40, 165])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_vec_kernel_bad_diagonal_both_layouts(cuda_device, monkeypatch, layout, t, dtype):
    """A zero diagonal entry (first and a middle panel), a negative one (the
    last row) and a NaN one: inf / NaN in z and alpha and -inf / NaN in
    logdet of that matrix only, as the plain version; forward-only alike."""
    _force_layout(monkeypatch, layout)
    l, y = _solve_vec_inputs(6, t, dtype, cuda_device, seed=1)
    l[1, 3, 3] = 0.0
    l[2, t // 2, t // 2] = 0.0
    l[3, t - 1, t - 1] = -1.0
    l[4, 10, 10] = float("nan")
    z, alpha, logdet = tlc.solve_vec(l, y)
    fz, flogdet = tlc.solve_vec_forward(l, y)
    z_ref, alpha_ref, ld_ref = tlc.solve_vec_reference(l, y)
    torch.cuda.synchronize()
    for i in (1, 2):
        assert logdet[i] == -float("inf") and ld_ref[i] == -float("inf")
        assert not torch.isfinite(z[i]).all() and not torch.isfinite(alpha[i]).all()
        assert torch.isfinite(z[i, :3 if i == 1 else t // 2]).all()
    assert torch.isnan(logdet[3]) and torch.isnan(ld_ref[3]) and torch.isfinite(z[3]).all()
    assert torch.isnan(logdet[4]) and torch.isnan(z[4, 10:]).all() and torch.isfinite(z[4, :10]).all()
    for out in (z, alpha, logdet):
        assert torch.isfinite(out[[0, 5]]).all()
    tol = 1e-3 if dtype == torch.float32 else 1e-10
    assert rel_err(z[[0, 3, 5]], z_ref[[0, 3, 5]]) < tol
    assert rel_err(alpha[[0, 3, 5]], alpha_ref[[0, 3, 5]]) < tol
    assert torch.equal(fz.nan_to_num(), z.nan_to_num()) and torch.equal(flogdet.isnan(), logdet.isnan())


def test_solve_vec_kernel_refuses_a_layout_that_does_not_fit(cuda_device, monkeypatch):
    """The resident layout one past its cap does not fit a block's shared
    memory: the launch raises (nothing falls back)."""
    caps = dict(tlc.SOLVE_VEC_RESIDENT_T_CAP)
    for dtype in (torch.float32, torch.float64):
        cap = caps[dtype]
        monkeypatch.setattr(tlc, "SOLVE_VEC_RESIDENT_T_CAP", {dtype: cap + 1})
        l, y = _solve_vec_inputs(1, cap + 1, dtype, cuda_device)
        with pytest.raises(RuntimeError, match="launch failed"):
            tlc.solve_vec(l, y)


def test_library_builds_for_sm90a(cuda_device):
    _build.library()
    assert _build.build_info["path"].endswith(".so")


# ------------------------------------------------------------- gridded sizes
# The 5-degree gridded step (benchmarks/gridded_bench.py): 5 models x 2,592
# cells = 12,960 GP fits at T = 86, and 10 realisations a fit, so the DBA
# update aligns N = 129,600 pairs a launch.  The plain versions run on a
# sample of the rows (rows are independent), including the last ones, where
# a 32-bit offset would go wrong first.
GRID_B, GRID_N, GRID_T = 12_960, 129_600, 86


def _sample_rows(n, k=256, seed=0):
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(seed))[:k]
    return torch.cat([rows, torch.arange(n - 8, n)]).unique()


def _gridded_spd(b, t, dtype, device, seed=0):
    """Matern-3/2 Grams on sorted inputs plus noise, built on the card (the
    batch is 383 MB in float32)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.randn((b, t), generator=gen, dtype=dtype), dim=1).values.to(device)
    noise = (0.05 + 0.15 * torch.rand((b, t), generator=gen, dtype=dtype)).to(device)
    d = (x[:, :, None] - x[:, None, :]).abs_().div_(1.3)
    k = (1.0 + 3.0 ** 0.5 * d) * torch.exp(-(3.0 ** 0.5) * d)
    del d
    k.diagonal(dim1=-2, dim2=-1).add_(noise)
    y = torch.randn((b, t), generator=gen, dtype=dtype).to(device)
    return k, y


def test_dba_update_kernel_at_the_gridded_batch(cuda_device):
    c, s = _dba_pairs(GRID_N, GRID_T, torch.float32, cuda_device)
    reset_launch_counts()
    got_s, got_c = dtw_cuda.dba_update_batch(c, s, impl="fused")
    assert launch_counts()["dba_update"] == 1
    rows = _sample_rows(GRID_N).to(cuda_device)
    want_s, want_c = dtw_cuda.dba_update_batch_reference(c[rows], s[rows])
    torch.cuda.synchronize()
    assert torch.equal(got_s[rows], want_s) and torch.equal(got_c[rows], want_c)


# The step's whole batch, and one model's cells (the library route's batch).
@pytest.mark.parametrize("b", [GRID_B, GRID_B // 5])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
def test_chol_solve_and_tri_inv_kernels_at_the_gridded_batch(cuda_device, dtype, tol, b):
    ky, y = _gridded_spd(b, GRID_T, dtype, cuda_device)
    reset_launch_counts()
    l, z, alpha, logdet = tlc.chol_solve(ky, y)
    w = tlc.tri_inv(l)
    assert launch_counts()["chol_solve"] == 1 and launch_counts()["tri_inv"] == 1
    rows = _sample_rows(b).to(cuda_device)
    want = tlc.chol_solve_reference(ky[rows], y[rows])
    want_w = tlc.tri_inv_reference(want[0])
    torch.cuda.synchronize()
    for g, w_ in zip((l, z, alpha, logdet), want):
        assert rel_err(g[rows], w_) < tol
    assert rel_err(w[rows], want_w) < tol


def test_gridded_step_on_the_card_matches_the_cpu(cuda_device):
    """``gridded_ensemble_step`` through the kernels (float64 on the card)
    against the plain versions on the CPU, at a 4 x 4 grid of 2 models; the
    launches are the ones the step implies."""
    from bayesian_ensembling_tpu_torch.parallel import gridded

    rng = np.random.default_rng(0)
    m, c, r, t = 2, 16, 5, GRID_T
    signal = np.sin(np.linspace(0, 3, t))
    block = signal + 0.3 * rng.normal(size=(m, c, r, t))
    obs = signal + 0.3 * rng.normal(size=(c, 10, t))
    mask = np.ones((m, c, r), bool)
    kw = dict(n_optim_nits=6, dba_iterations=3, optimizer="bfgs")
    reset_launch_counts()
    got = gridded.gridded_ensemble_step(
        *(torch.from_numpy(a).to(cuda_device) for a in (block, obs, mask)), **kw)
    counts = launch_counts()
    want = gridded.gridded_ensemble_step(*(torch.from_numpy(a) for a in (block, obs, mask)), **kw)
    # One DBA update an iteration; a value and gradient (B2 + B3) and a
    # value-only proposal (B2) a BFGS step; B2 + B3 for the posterior.
    assert counts["dba_update"] == 3
    assert counts["chol_solve"] == 2 * 6 + 1 and counts["tri_inv"] == 6 + 1
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w_.numpy(), rtol=0, atol=1e-8)


# ------------------------------------------------------------- the Gram kernels
# The annual fits (112, 165) and (112, 86), one gridded model's cells (2,592,
# 86), chip_smoke.py's gridded batch (12,960, 86) and the gridded cell's
# (41,472, 86), and the monthly campaign's SSP fit (65, 1032) and historical
# chunk (28, 1980).
GRAM_SHAPES = [(112, 165), (112, 86), (2592, 86), (12960, 86), (41472, 86), (65, 1032),
               (28, 1980)]
# The contraction's limits by dtype, each a share of a matrix's sum of
# |terms| (the terms cancel): float64 against autograd of the chain, float32
# against float64, and the NLML's gradient on the Gram kernels against the
# chain's.  Each lies between the largest reading of the kernel and the
# least of a control whose terms are rounded to the next precision below
# (GRAD_CONTROL), which must miss it: on an H100, float64 2.5e-18-9.4e-17
# against float32 terms 1.4e-10-3.1e-9; float32 5.5e-10-1.8e-8 against
# bfloat16 terms 8.1e-6-2.2e-4 (PERF.md section 6, PR 24).
GRAD_TOL = {torch.float64: 1e-13, torch.float32: 3e-7}
GRAD_CONTROL = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def _gram_inputs(b, t, dtype, device, seed=0):
    """The fit's hoisted distances of 3-realisation random walks (built on
    the card), hyperparameters around the scratch start, noise, and for the
    contraction a symmetric K^-1, alpha and the two output weights."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops

    gen = torch.Generator().manual_seed(seed)
    walk = torch.cumsum(0.1 * torch.randn((b, t, 3), generator=gen, dtype=dtype), dim=1)
    x = (torch.linspace(0.0, 1.0, t, dtype=dtype)[None, :, None] + walk).to(device)
    dist = gp_ops.get_kernel_precomputed("matern32")[0](x, x)
    ls = (0.5 + 1.5 * torch.rand((b,), generator=gen, dtype=dtype)).to(device)
    var = (0.5 + 1.5 * torch.rand((b,), generator=gen, dtype=dtype)).to(device)
    noise = (0.01 + 0.2 * torch.rand((b, t), generator=gen, dtype=dtype)).to(device)
    dev_gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((b, t, t), generator=dev_gen, dtype=dtype, device=device)
    kinv = (a + a.mT).mul_(0.5)
    del a
    alpha = torch.randn((b, t), generator=gen, dtype=dtype).to(device)
    g_quad = (0.25 + torch.rand((b,), generator=gen, dtype=dtype)).to(device)
    g_logdet = (0.25 + torch.rand((b,), generator=gen, dtype=dtype)).to(device)
    return dist, ls, var, noise, kinv, alpha, g_quad, g_logdet


@pytest.mark.parametrize("b,t", GRAM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_kernel_equals_the_chain_bit_for_bit(cuda_device, b, t, dtype):
    from bayesian_ensembling_tpu_torch.ops import gram

    dist, ls, var, noise, *_ = _gram_inputs(b, t, dtype, cuda_device)
    reset_launch_counts()
    got = gram.gram_matern32(dist, ls, var, noise, 1e-6)
    assert launch_counts()["gram_matern32"] == 1
    want = gram.gram_matern32_reference(dist, ls, var, noise, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _term_scale(kinv, alpha, g_quad, g_logdet, dist, ls, var):
    """Each matrix's sums of the contraction's terms' absolute values
    (g_lengthscale's, g_variance's), in float64: the scale of each sum's
    round-off, since the terms cancel."""
    from bayesian_ensembling_tpu_torch.ops import gram

    g_ky = tlc.nlml_g_ky(*(a.double() for a in (kinv, alpha, g_quad, g_logdet)))
    ls, var = ls.double(), var.double()
    s = gram.SQRT3 * dist.double() / ls[:, None, None]
    e = torch.exp(-s)
    return ((g_ky * (s * s * e)).abs().sum(dim=(1, 2)) * var / ls,
            (g_ky * ((1.0 + s) * e)).abs().sum(dim=(1, 2)))


def _terms_rounded_to(dtype, kinv, alpha, g_quad, g_logdet, dist, ls, var):
    """The control of a contraction that works at lower precision: each term
    computed in float64 from the inputs, rounded to ``dtype``, and summed in
    float64."""
    from bayesian_ensembling_tpu_torch.ops import gram

    g_ky = tlc.nlml_g_ky(*(a.double() for a in (kinv, alpha, g_quad, g_logdet)))
    ls, var = ls.double(), var.double()
    s = gram.SQRT3 * dist.double() / ls[:, None, None]
    e = torch.exp(-s)
    g_var = (g_ky * ((1.0 + s) * e)).to(dtype).double().sum(dim=(1, 2))
    g_ls = var / ls * (g_ky * (s * s * e)).to(dtype).double().sum(dim=(1, 2))
    return g_ls, g_var


def _gap(got, want, scale):
    """The largest gap of (g_lengthscale, g_variance) over the batch, each
    matrix's a share of its sum of |terms|."""
    return max(((g.double() - w.double()).abs() / sc).max().item()
               for g, w, sc in zip(got, want, scale))


def _chain_grads(dist, ls, var, noise, kinv, alpha, g_quad, g_logdet):
    """Autograd of the chain's Gram against the NLML's d/dK."""
    from bayesian_ensembling_tpu_torch.ops import gram

    g_ky = tlc.nlml_g_ky(kinv, alpha, g_quad, g_logdet)
    ls_, var_ = ls.clone().requires_grad_(True), var.clone().requires_grad_(True)
    ky = gram.gram_matern32_reference(dist, ls_, var_, noise, 1e-6)
    return torch.autograd.grad((g_ky * ky).sum(), (ls_, var_))


@pytest.mark.parametrize("b,t", GRAM_SHAPES)
def test_gram_grad_kernel_matches_autograd_of_the_chain(cuda_device, b, t):
    """float64 within GRAD_TOL of autograd of the chain, and float32 within
    GRAD_TOL of float64 on the same inputs, each a share of the sum of the
    terms' absolute values; the terms rounded to the next precision below
    (GRAD_CONTROL) must miss each limit."""
    from bayesian_ensembling_tpu_torch.ops import gram

    args = _gram_inputs(b, t, torch.float64, cuda_device)
    dist, ls, var, noise, kinv, alpha, g_quad, g_logdet = args
    grad_args = (kinv, alpha, g_quad, g_logdet, dist, ls, var)
    reset_launch_counts()
    got = gram.gram_matern32_grad(*grad_args)
    assert launch_counts()["gram_matern32_grad"] == 1
    scale = _term_scale(*grad_args)
    want = _chain_grads(*args)
    assert _gap(got, want, scale) < GRAD_TOL[torch.float64]
    control = _terms_rounded_to(GRAD_CONTROL[torch.float64], *grad_args)
    assert _gap(control, want, scale) > GRAD_TOL[torch.float64]
    del kinv, args, grad_args, want, control
    a32 = [a.to(torch.float32) for a in _gram_inputs(b, t, torch.float64, cuda_device)]
    d32, l32, v32, _, k32, al32, gq32, gl32 = a32
    grad_args = (k32, al32, gq32, gl32, d32, l32, v32)
    got32 = gram.gram_matern32_grad(*grad_args)
    want64 = gram.gram_matern32_grad(*(a.double() for a in grad_args))
    control = _terms_rounded_to(GRAD_CONTROL[torch.float32], *grad_args)
    torch.cuda.synchronize()
    assert all(g.dtype == torch.float32 for g in got32)
    assert _gap(got32, want64, scale) < GRAD_TOL[torch.float32]
    assert _gap(control, want64, scale) > GRAD_TOL[torch.float32]


@pytest.mark.parametrize("b,t", GRAM_SHAPES)
def test_gram_kernels_give_the_same_bits_twice_and_in_any_batch(cuda_device, b, t):
    """Two launches of each kernel give the same bits, and a matrix's
    gradient does not depend on the batch it is in (the ranges depend on T
    alone)."""
    from bayesian_ensembling_tpu_torch.ops import gram

    dist, ls, var, noise, kinv, alpha, g_quad, g_logdet = _gram_inputs(
        b, t, torch.float32, cuda_device)
    grad_args = (kinv, alpha, g_quad, g_logdet, dist, ls, var)
    first = gram.gram_matern32_grad(*grad_args)
    again = gram.gram_matern32_grad(*grad_args)
    part = gram.gram_matern32_grad(*(a[3:b // 2] for a in grad_args))
    ky = gram.gram_matern32(dist, ls, var, noise, 1e-6)
    ky2 = gram.gram_matern32(dist, ls, var, noise, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(ky, ky2)
    for f, a, p in zip(first, again, part):
        assert torch.equal(f, a) and torch.equal(f[3:b // 2], p)


@pytest.mark.parametrize("b,t,dtype,route", [
    (112, 165, torch.float32, "kernel"),  # the annual historical fit
    (16, 165, torch.float64, "kernel"),  # run_scenario's batch in float64
    (8, 250, torch.float32, "library"),  # past the kernels' cap: torch.linalg
    (28, 1980, torch.float32, "blocked"),  # the monthly historical chunk
])
def test_nlml_terms_on_the_gram_kernels_match_the_chain(cuda_device, b, t, dtype, route):
    """``ops/gram.matern32_nlml_terms`` on the card: the values equal the
    chain's NLML bit for bit on every route; the gradients agree with
    autograd of the chain within GRAD_TOL, a share of each matrix's sum
    of |terms| of the route's own K^-1 and alpha, and that contraction with
    its terms rounded to the next precision below misses the limit."""
    from bayesian_ensembling_tpu_torch.ops import gram

    dist, ls, var, noise, *_ = _gram_inputs(b, t, dtype, cuda_device)
    y = torch.randn((b, t), generator=torch.Generator().manual_seed(1), dtype=dtype).to(cuda_device)
    assert tlc.linalg_path(t, b=b, dtype=dtype) == route
    out = []
    for use_gram in (False, True):
        reset_launch_counts()
        ls_, var_ = ls.clone().requires_grad_(True), var.clone().requires_grad_(True)
        if use_gram:
            quad, logdet = gram.matern32_nlml_terms(dist, ls_, var_, noise, y, 1e-6, route)
        else:
            ky = gram.gram_matern32_reference(dist, ls_, var_, noise, 1e-6)
            quad, logdet = (tlb.nlml_terms_blocked(ky, y) if route == "blocked"
                            else tlc.nlml_terms(ky, y))
        grads = torch.autograd.grad((0.5 * (quad + logdet)).sum(), (ls_, var_))
        out.append((quad, logdet, *grads, launch_counts(), route_counts()))
    (q0, l0, gl0, gv0, n0, r0), (q1, l1, gl1, gv1, n1, r1) = out
    with torch.no_grad():  # the K^-1 and alpha the backward contracts
        forward, kinv_of = tlb.nlml_route(route)
        _, _, factor, alpha = forward(gram.gram_matern32_reference(dist, ls, var, noise, 1e-6), y)
        half = torch.full_like(ls, 0.5)
        grad_args = (kinv_of(factor), alpha, half, half, dist, ls, var)
        scale = _term_scale(*grad_args)
        control = _terms_rounded_to(GRAD_CONTROL[dtype], *grad_args)
    torch.cuda.synchronize()
    assert torch.equal(q0, q1) and torch.equal(l0, l1)
    assert _gap((gl1, gv1), (gl0, gv0), scale) < GRAD_TOL[dtype]
    assert _gap(control, (gl0, gv0), scale) > GRAD_TOL[dtype]
    assert (n1["gram_matern32"], n1["gram_matern32_grad"]) == (1, 1)
    assert (n0["gram_matern32"], n0["gram_matern32_grad"]) == (0, 0)
    assert r0 == r1


def test_gaussian_crps_in_place_equals_the_expression_on_the_card(cuda_device):
    """``scoring.gaussian_crps`` (in place, two buffers) against the formula
    as one expression, at a slice of the gridded tail's (M, C, R_obs, T)."""
    from bayesian_ensembling_tpu_torch.ops import scoring

    gen = torch.Generator().manual_seed(0)
    obs = torch.randn((1, 256, 200, 86), generator=gen).to(cuda_device)
    mu = torch.randn((16, 256, 1, 86), generator=gen).to(cuda_device)
    sigma = (0.1 + torch.rand((16, 256, 1, 86), generator=gen)).to(cuda_device)
    z = (obs - mu) / sigma
    cdf = 0.5 * (1.0 + torch.erf(z * scoring._INV_SQRT_2))
    pdf = scoring._INV_SQRT_2PI * torch.exp(-0.5 * (z * z))
    want = sigma * (z * (2.0 * cdf - 1.0) + 2.0 * pdf - scoring._INV_SQRT_PI)
    assert torch.equal(scoring.gaussian_crps(obs, mu, sigma), want)
