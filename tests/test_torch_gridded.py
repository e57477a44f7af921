"""The port's gridded surface (``parallel/gridded.py``) against the JAX
package, in float64, at a tiny grid (M = 2 models, C = 4 or 12 cells,
R = 3 realisations, T = 12).

Tolerances: the cell bookkeeping (padding, coarse indices, chunk bounds) is
exact; the tail is the same elementwise arithmetic on both sides up to the
order of sums (1e-12); the step and the warm start run the same DBA, fit,
posterior and tail as ``tests/test_torch_step.py`` and hold its TOL = 1e-8;
the float64 refinement reruns the posterior through other solvers at the
same hyperparameters and targets (1e-10, as ``tests/test_torch_weights.py``),
and chunked equals unchunked to 1e-12.
"""

import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.parallel import gridded as jg
from bayesian_ensembling_tpu.parallel import step as jstep
from bayesian_ensembling_tpu_torch import convert
from bayesian_ensembling_tpu_torch.parallel import gridded as tg

from test_torch_dtw_subgradient import jax_orders  # noqa: F401  (fixture)

torch.set_num_threads(1)

TOL = 1e-8
TAIL_TOL = 1e-12
REFINED_TOL = 1e-10
CHUNK_TOL = 1e-12
KW = dict(n_optim_nits=4, dba_iterations=2)


def gridded_blocks(seed, m=2, c=4, r=3, t=12, r_obs=5):
    """The gridded bench's workload in miniature: a shared signal plus noise
    per (model, cell, realisation), observations around the same signal;
    one padded realisation slot."""
    rng = np.random.default_rng(seed)
    signal = np.sin(np.linspace(0.0, 3.0, t))
    block = signal + 0.3 * rng.normal(size=(m, c, r, t))
    obs = signal + 0.3 * rng.normal(size=(c, r_obs, t))
    mask = np.ones((m, c, r), bool)
    mask[1, 0, 2] = False
    block[~mask] = 0.0
    return block, obs, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=tol)


def _params_close(got, want, tol):
    np.testing.assert_allclose(got.raw_lengthscale.detach().numpy(),
                               np.asarray(want.raw_lengthscale), rtol=0, atol=tol)
    np.testing.assert_allclose(got.raw_variance.detach().numpy(),
                               np.asarray(want.raw_variance), rtol=0, atol=tol)


@pytest.mark.parametrize("n_devices", [1, 3, 4, 8])
def test_pad_cells_matches_jax(n_devices):
    block, _, mask = gridded_blocks(0)
    b1, m1 = block[0], mask[0]
    got = tg.pad_cells(b1, m1, n_devices)
    want = jg.pad_cells(b1, m1, n_devices)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == 4


@pytest.mark.parametrize("lat,lon,stride", [(3, 4, 1), (3, 4, 2), (5, 7, 3), (36, 72, 5), (2, 2, 4)])
def test_coarse_cell_indices_match_jax(lat, lon, stride):
    got = tg.coarse_cell_indices(lat, lon, stride)
    want = jg.coarse_cell_indices(lat, lon, stride)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_coarse_cell_indices_rejects_stride_below_one():
    with pytest.raises(ValueError, match="stride"):
        tg.coarse_cell_indices(3, 4, 0)


@pytest.mark.parametrize("n,chunk", [(10, None), (10, 1), (10, 3), (10, 4), (10, 5), (10, 10),
                                     (10, 11), (7, 2), (1, 1)])
def test_chunk_bounds_match_jax(n, chunk):
    assert tg._chunk_bounds(n, chunk) == jg._chunk_bounds(n, chunk)


@pytest.mark.parametrize("chunk", [-1, -5, 0])
def test_chunk_bounds_reject_chunks_below_one(chunk):
    """ROADMAP C4: the JAX version takes a negative chunk and fails later."""
    with pytest.raises(ValueError, match="chunk"):
        tg._chunk_bounds(10, chunk)


@pytest.mark.parametrize("weight_kind", jstep.WEIGHT_KINDS)
@pytest.mark.parametrize("sigma_mode", ["w2", "mixture"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_gridded_tail_matches_jax(weight_kind, sigma_mode, use_mask):
    rng = np.random.default_rng(3)
    m, c, t = 3, 4, 9
    mean = rng.normal(size=(m, c, t))
    var = rng.uniform(0.01, 0.2, (m, c, t))
    block, obs, mask = gridded_blocks(4, m=m, c=c, t=t)
    mm = np.array([1.0, 0.0, 1.0]) if use_mask else None
    want = jg.gridded_tail(*_j(mean, var, obs, block, mask), None if mm is None else jnp.asarray(mm),
                           weight_kind=weight_kind, sigma_mode=sigma_mode)
    got = tg.gridded_tail(*_t(mean, var, obs, block, mask), None if mm is None else _t(mm)[0],
                          weight_kind=weight_kind, sigma_mode=sigma_mode)
    assert got[0].shape == (c, t) and got[2].shape == (m, c)
    _close(got, want, TAIL_TOL)
    if use_mask:
        assert (got[2][1] == 0).all()


@pytest.mark.parametrize("optimizer,dba_method", [("adam", "classic"), ("bfgs", "classic"),
                                                  ("adam", "subgradient")])
def test_gridded_step_matches_jax(jax_orders, optimizer, dba_method):  # noqa: F811
    block, obs, mask = gridded_blocks(5)
    kw = dict(KW, optimizer=optimizer, dba_method=dba_method)
    want = jg.gridded_ensemble_step(*_j(block, obs, mask), **kw)
    got = tg.gridded_ensemble_step(*_t(block, obs, mask), **kw)
    assert got[0].shape == (4, 12) and got[1].shape == (4, 12) and got[2].shape == (2, 4)
    _close(got, want, TOL)
    np.testing.assert_allclose(got[2].sum(dim=0).numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("optimizer", ["adam", "bfgs"])
def test_gridded_step_gp_init_and_return_fit_match_jax(optimizer):
    block, obs, mask = gridded_blocks(6)
    rng = np.random.default_rng(6)
    ls, var = rng.uniform(0.2, 1.5, (2, 4)), rng.uniform(-0.5, 0.8, (2, 4))
    jinit = jax.tree.map(jnp.asarray, jg.gp_ops.GPParams(raw_lengthscale=ls, raw_variance=var))
    tinit = convert.gridded_gp_params_from_jax(jinit, "cpu", torch.float64)
    kw = dict(KW, optimizer=optimizer, return_fit=True)
    want = jg.gridded_ensemble_step(*_j(block, obs, mask), gp_init=jinit, **kw)
    got = tg.gridded_ensemble_step(*_t(block, obs, mask), gp_init=tinit, **kw)
    _close(got[:3], want[:3], TOL)
    assert got[3].raw_lengthscale.shape == (2, 4)
    _params_close(got[3], want[3], TOL)
    _close(got[4:], want[4:], TOL)
    # The caller's warm start is copied, not modified.
    np.testing.assert_array_equal(tinit.raw_lengthscale.detach().numpy(), ls)
    # The fit it returns is the fit that produced the moments.
    again = tg.gridded_ensemble_step(*_t(block, obs, mask), gp_init=got[3],
                                     **dict(KW, n_optim_nits=0, optimizer=optimizer))
    _close(again, got[:3], 1e-12)


def test_gridded_step_model_mask_matches_jax():
    block, obs, mask = gridded_blocks(7, m=3)
    mm = np.array([1.0, 1.0, 0.0])
    want = jg.gridded_ensemble_step(*_j(block, obs, mask, mm), weight_kind="loglik",
                                    sigma_mode="mixture", **KW)
    got = tg.gridded_ensemble_step(*_t(block, obs, mask, mm), weight_kind="loglik",
                                   sigma_mode="mixture", **KW)
    _close(got, want, TOL)
    assert (got[2][2] == 0).all()


def test_coarse_warm_start_and_fit_params_match_jax():
    lat, lon, stride = 3, 4, 2
    block, obs, mask = gridded_blocks(8, c=lat * lon)
    kw = dict(n_optim_nits=5, dba_iterations=2, optimizer="bfgs")
    want = jg.coarse_warm_start(*_j(block, mask), lat, lon, stride, **kw)
    got = tg.coarse_warm_start(*_t(block, mask), lat, lon, stride, **kw)
    assert got.raw_lengthscale.shape == (2, lat * lon)
    _params_close(got, want, TOL)
    # Every fine cell carries its nearest coarse cell's hyperparameters.
    coarse, nearest = tg.coarse_cell_indices(lat, lon, stride)
    np.testing.assert_array_equal(got.raw_variance.detach().numpy()[:, coarse][:, nearest],
                                  got.raw_variance.detach().numpy())
    cb = block[:, coarse].reshape(-1, 3, 12)
    cm = mask[:, coarse].reshape(-1, 3)
    _params_close(tg.coarse_fit_params(*_t(cb, cm), **kw),
                  jg.coarse_fit_params(*_j(cb, cm), **kw), TOL)
    # ... and the warm start feeds the fine pass, as in the bench.
    fine = dict(KW, optimizer="bfgs")
    _close(tg.gridded_ensemble_step(*_t(block, obs, mask), gp_init=got, **fine),
           jg.gridded_ensemble_step(*_j(block, obs, mask), gp_init=want, **fine), TOL)


def test_coarse_warm_start_rejects_a_grid_of_another_size():
    block, _, mask = gridded_blocks(8, c=12)
    with pytest.raises(ValueError, match="lat\\*lon"):
        tg.coarse_warm_start(*_t(block, mask), 3, 5, 2, n_optim_nits=1)


def _fit(seed, c=5):
    """A float32-style fit on the JAX side: its hyperparameters and targets."""
    block, obs, mask = gridded_blocks(seed, c=c)
    out = jg.gridded_ensemble_step(*_j(block, obs, mask), return_fit=True, **KW)
    return block, obs, mask, out[3], (np.asarray(out[4]), np.asarray(out[5]))


@pytest.mark.parametrize("chunk", [None, 1, 3, 4, 7, 10, 11])
def test_refine_marginals_f64_matches_jax_and_chunks(chunk):
    block, _, mask, params, (ym, yv) = _fit(9)
    m, c, r, t = block.shape
    flat = lambda a: np.asarray(a).reshape((m * c,) + np.shape(a)[2:])  # noqa: E731
    jp = jax.tree.map(flat, params)
    want = jg.refine_marginals_f64(flat(block), flat(mask), jp, (flat(ym), flat(yv)))
    tp_ = convert.gp_params_from_jax(jp.raw_lengthscale, jp.raw_variance, "cpu", torch.float64)
    got = tg.refine_marginals_f64(flat(block), flat(mask), tp_, (flat(ym), flat(yv)),
                                  device="cpu", chunk=chunk)
    assert got[0].dtype == torch.float64 and got[0].shape == (m * c, t)
    _close(got, want, REFINED_TOL)
    whole = tg.refine_marginals_f64(flat(block), flat(mask), tp_, (flat(ym), flat(yv)),
                                    device="cpu")
    _close(got, whole, CHUNK_TOL)


@pytest.mark.parametrize("cell_chunk", [None, 1, 2, 3, 5])
@pytest.mark.parametrize("weight_kind,sigma_mode", [("crps", "w2"), ("loglik", "mixture"),
                                                    ("inverse_square", "w2")])
def test_refined_gridded_f64_matches_jax_and_chunks(cell_chunk, weight_kind, sigma_mode):
    block, obs, mask, params, targets = _fit(10)
    mm = np.array([1.0, 1.0])
    kw = dict(weight_kind=weight_kind, sigma_mode=sigma_mode)
    want = jg.refined_gridded_f64(block, obs, mask, params, targets, model_mask=mm, **kw)
    tp_ = convert.gridded_gp_params_from_jax(params, "cpu", torch.float64)
    got = tg.refined_gridded_f64(block, obs, mask, tp_, targets, model_mask=mm, device="cpu",
                                 cell_chunk=cell_chunk, **kw)
    assert all(isinstance(a, np.ndarray) and a.dtype == np.float64 for a in got)
    assert got[0].shape == (5, 12) and got[2].shape == (2, 5)
    _close(got, want, REFINED_TOL)
    whole = tg.refined_gridded_f64(block, obs, mask, tp_, targets, model_mask=mm, device="cpu",
                                   **kw)
    _close(got, whole, CHUNK_TOL)


def test_refined_gridded_f64_accepts_tensors_from_the_port_step():
    block, obs, mask = gridded_blocks(11)
    out = tg.gridded_ensemble_step(*_t(block.astype(np.float32), obs.astype(np.float32), mask),
                                   return_fit=True, **KW)
    refined = tg.refined_gridded_f64(*_t(block.astype(np.float32), obs.astype(np.float32), mask),
                                     out[3], out[4:], device="cpu", cell_chunk=3)
    drift = max(np.abs(refined[0] - out[0].double().numpy()).max(),
                np.abs(refined[1] - out[1].double().numpy()).max())
    assert np.isfinite(refined[0]).all() and drift < 1e-4


def test_gridded_step_rejects_unknown_options_before_fitting():
    block, obs, mask = gridded_blocks(13)
    with pytest.raises(ValueError, match="sigma_mode"):
        tg.gridded_ensemble_step(*_t(block, obs, mask), sigma_mode="compat", **KW)
    with pytest.raises(ValueError, match="weight_kind"):
        tg.gridded_ensemble_step(*_t(block, obs, mask), weight_kind="nope", **KW)


# ------------------------------------------------- chip_smoke.py's copies
def _bench_modules():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for sub in ("", "benchmarks"):
        path = os.path.join(root, sub) if sub else root
        if path not in sys.path:
            sys.path.insert(0, path)
    import chip_smoke
    import gridded_bench
    import gridded_common

    return chip_smoke, gridded_common, gridded_bench


@pytest.mark.parametrize("config", [
    dict(n_iters=30, optimizer="bfgs", warm_stride=0, fine_nits=None, lat=36, lon=72),
    dict(n_iters=500, warm_stride=0, fine_nits=None, lat=36, lon=72),
    dict(n_iters=30, optimizer="bfgs", warm_stride=5, fine_nits=20, lat=36, lon=72),
    dict(n_iters=30, optimizer="bfgs", warm_stride=5, fine_nits=10, lat=180, lon=360),
    dict(n_iters=7, warm_stride=0, fine_nits=None, lat=36, lon=72),
])
def test_chip_smoke_oracle_pick_is_the_gridded_bench_pick(config):
    chip_smoke, _, gridded_bench = _bench_modules()
    for name in ("gridded_oracle.json", "gridded_oracle_warm.json"):
        entries = chip_smoke._oracle_entries(name)
        with open(os.path.join(os.path.dirname(gridded_bench.__file__), name)) as fh:
            loaded = json.load(fh)
        got = chip_smoke.select_oracle_entry(entries, n_cells=2592, **config)
        want = gridded_bench.select_oracle_entry(loaded, n_cells=2592, **config)
        assert got == want


def _warm_first_cells(pkg, dtype, n_cells):
    """The bench's coarse-to-fine warm start (stride 5 on the 36 x 72 grid,
    bfgs-30 coarse, bfgs-20 fine) on the first cells, fitting only the
    coarse cells they need (``gridded_common.coarse_params_for``): the
    barycentre mean and std as numpy arrays."""
    _, gridded_common, _ = _bench_modules()
    cells = np.arange(n_cells)
    block, obs = gridded_common.make_workload_cells(cells, dtype)
    mask = np.ones(block.shape[:3], bool)
    if pkg == "jax":
        init = gridded_common.coarse_params_for(cells, 36, 72, 5, 30, dtype, optimizer="bfgs")
        out = jg.gridded_ensemble_step(*_j(block, obs, mask), gp_init=init, n_optim_nits=20,
                                       optimizer="bfgs")
    else:
        coarse, nearest = tg.coarse_cell_indices(36, 72, 5)
        need = np.unique(nearest[cells])
        cblock, _ = gridded_common.make_workload_cells(coarse[need], dtype)
        m, nc, r, t = cblock.shape
        params = tg.coarse_fit_params(*_t(cblock.reshape(m * nc, r, t), np.ones((m * nc, r), bool)),
                                      n_optim_nits=30, optimizer="bfgs")
        pick = np.searchsorted(need, nearest[cells])
        init = tg.gp_ops.BatchedGPParams(params.raw_lengthscale.reshape(m, nc)[:, pick],
                                         params.raw_variance.reshape(m, nc)[:, pick])
        out = tg.gridded_ensemble_step(*_t(block, obs, mask), gp_init=init, n_optim_nits=20,
                                       optimizer="bfgs")
    return np.asarray(out[0], np.float64), np.asarray(out[1], np.float64)


def _gridded_entries():
    chip_smoke, _, _ = _bench_modules()
    oracle = chip_smoke._oracle_entries("gridded_oracle.json")
    pick = dict(n_cells=2592, warm_stride=0, fine_nits=None, lat=36, lon=72)
    return {
        "adam-500": chip_smoke.select_oracle_entry(oracle, n_iters=500, **pick),
        "adam-2000": chip_smoke.select_oracle_entry(oracle, n_iters=2000, **pick),
        "bfgs-30": chip_smoke.select_oracle_entry(oracle, n_iters=30, optimizer="bfgs", **pick),
        "warm": chip_smoke.select_oracle_entry(
            chip_smoke._oracle_entries("gridded_oracle_warm.json"), n_iters=30, n_cells=2592,
            warm_stride=5, fine_nits=20, lat=36, lon=72, optimizer="bfgs"),
    }


def test_warm_start_meets_the_jax_oracle_in_float64():
    """The port's warm path is the oracle's algorithm: in float64 it lands on
    the JAX package's float64 moments (``gridded_oracle_warm.json``)."""
    entry = _gridded_entries()["warm"]
    mean, std = _warm_first_cells("torch", np.float64, 16)
    assert max(np.abs(mean - np.asarray(entry["bary_mean"])[:16]).max(),
               np.abs(std - np.asarray(entry["bary_std"])[:16]).max()) < 1e-6


@pytest.mark.parametrize("run", ["adam-500", "adam-2000", "bfgs-30", "warm"])
def test_chip_smoke_quality_gate_is_the_gridded_bench_quality_gate(run):
    """``chip_smoke.py``'s copy of ``gridded_bench.quality_gate_check``: the
    same distances to the Adam-2000 truth, and the same verdict with the
    bench's scratch Adam-500 baseline.  The bfgs entries miss that baseline
    (ROADMAP C11), which is why ``chip_smoke.py`` holds the float32 warm
    start to the JAX float64 run of its own configuration instead."""
    chip_smoke, _, gridded_bench = _bench_modules()
    entries = _gridded_entries()
    mean, std = np.asarray(entries[run]["bary_mean"]), np.asarray(entries[run]["bary_std"])
    got, base = chip_smoke.quality_gap(mean, std, entries["adam-2000"], entries["adam-500"])
    with open(os.path.join(os.path.dirname(gridded_bench.__file__), "gridded_oracle.json")) as fh:
        loaded = json.load(fh)
    try:
        want = gridded_bench.quality_gate_check(loaded, mean, std, n_cells=2592, lat=36, lon=72)
    except SystemExit:
        want = None
    assert chip_smoke.quality_ok(got, base) == (want is not None)
    assert want is None or got == want
    assert (want is None) == run.startswith(("bfgs", "warm"))


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_float32_warm_start_meets_the_quality_gate(pkg):
    """The float32 warm start on the first 32 cells is no further from the
    float64 Adam-2000 truth than the JAX float64 run of the same
    configuration, with the bench's 2% slack: the gate ``chip_smoke.py``
    puts on the card's float32 warm start, met by both packages."""
    chip_smoke, _, _ = _bench_modules()
    entries = _gridded_entries()
    run, base = chip_smoke.quality_gap(*_warm_first_cells(pkg, np.float32, 32),
                                       entries["adam-2000"], entries["warm"])
    assert chip_smoke.quality_ok(run, base), (run, base)
