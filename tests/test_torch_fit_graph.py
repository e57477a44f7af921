"""The Adam fit on a card as one CUDA graph of the step (``ops/gp._adam_graphed``)
against the eager loop of ``_build_batch_step``, and the counters it keeps.

On a card, ``fit_gp_batch_segment`` runs a segment's first
``GRAPH_WARMUP_STEPS`` Adam steps eagerly, captures the next and replays it
for the rest; the tests here hold that to the plain Python loop of the same
step, bit for bit, on the parameters, the optimiser state and the losses.
The card tests skip without CUDA; the file imports no JAX, so it also runs
where only PyTorch is installed:

    python -m pytest tests/test_torch_fit_graph.py -m gpu --noconftest
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import bayesian_ensembling_tpu_torch as bt
from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
from bayesian_ensembling_tpu_torch.utils import profiling

torch.set_num_threads(1)

WARMUP = gp_ops.GRAPH_WARMUP_STEPS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA graph and the kernels have no CPU mode)")
    return torch.device("cuda")


def _flagship_inputs(t, device):
    """The fit inputs of the annual flagship's 7 x 16 padded models at
    ``t`` = 165 (historical) or 86 (SSP), from ``chip_smoke.py``'s
    synthetic inputs (seed 0): DBA-10 targets, noise and features."""
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hb, hm, sb, sm, *_ = smoke.synthetic_flagship(0)
    block, mask = (hb, hm) if t == hb.shape[-1] else (sb, sm)
    block = torch.as_tensor(block.reshape(-1, *block.shape[2:]), dtype=torch.float32)
    mask = torch.as_tensor(mask.reshape(-1, mask.shape[-1]))
    return gp_ops.prepare_gp_inputs(block.to(device), mask.to(device), dba_iterations=10)


def _random_inputs(b, t, dtype, device, seed=7):
    """Trend plus AR(1)-like noise in 4 realisations a model, 2 DBA steps."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(0.05 * rng.normal(size=(b, 4, t)), axis=-1)
    block = torch.as_tensor(np.linspace(0.0, 1.0, t) + walk, dtype=dtype, device=device)
    mask = torch.ones((b, 4), dtype=torch.bool, device=device)
    return gp_ops.prepare_gp_inputs(block, mask, dba_iterations=2)


def _eager(x, y, noise, n, init=None, learning_rate=0.01):
    """The eager loop: ``_build_batch_step``'s Adam step called ``n`` times."""
    params = gp_ops._start_params(x.shape[0], y, init)
    opt = gp_ops._Adam(list(params.parameters()), learning_rate)
    step = gp_ops._build_batch_step(x, y, noise, "matern32", 1e-6, "adam")
    losses = torch.empty((n, x.shape[0]), dtype=y.dtype, device=y.device)
    for it in range(n):
        losses[it] = step(params, opt)
    return params, opt, losses.T


def _assert_same_fit(got, want):
    (p1, l1), (p2, l2) = got, want
    assert torch.equal(p1.raw_lengthscale, p2.raw_lengthscale)
    assert torch.equal(p1.raw_variance, p2.raw_variance)
    assert torch.equal(l1, l2)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [165, 86])
def test_graphed_fit_equals_the_eager_loop_at_the_flagship_shapes(cuda_device, t):
    x, y, noise = _flagship_inputs(t, cuda_device)
    assert y.shape == (112, t)
    p_eager, opt_eager, l_eager = _eager(x, y, noise, 60)
    params = gp_ops._start_params(112, y, None)
    opt = gp_ops._make_batch_opt("adam", 0.01, params)
    bt.reset_launch_counts()
    _, _, losses = gp_ops.fit_gp_batch_segment(x, y, noise, params, opt, n_steps=60)
    assert bt.fit_replay_counts() == {"adam": 60 - WARMUP}
    _assert_same_fit((params, losses), (p_eager, l_eager))
    assert opt.count == opt_eager.count == 60
    for a, b in zip(opt.mu + opt.nu, opt_eager.mu + opt_eager.nu):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, dtype, route", [
    (16, 165, torch.float64, "kernel"),  # run_scenario's batch, the f64 kernel route
    (8, 250, torch.float32, "library"),  # past the kernels' cap: torch.linalg
    (64, 250, torch.float32, "blocked"),  # the recursive blocked NLML
])
def test_graphed_fit_equals_the_eager_loop_on_every_route(cuda_device, b, t, dtype, route):
    x, y, noise = _random_inputs(b, t, dtype, cuda_device)
    assert bt.linalg_path(t, b=b, dtype=dtype) == route
    want = _eager(x, y, noise, 12)
    _assert_same_fit(gp_ops.fit_gp_batch(x, y, noise, n_optim_nits=12), (want[0], want[2]))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 3])
def test_segments_below_the_capture_run_eagerly(cuda_device, n):
    x, y, noise = _flagship_inputs(86, cuda_device)
    want = _eager(x, y, noise, n)
    bt.reset_launch_counts()
    _assert_same_fit(gp_ops.fit_gp_batch(x, y, noise, n_optim_nits=n), (want[0], want[2]))
    assert bt.fit_replay_counts() == {"adam": 0}
    assert bt.fit_step_counts()["adam"] == n


@pytest.mark.gpu
def test_chunked_graphed_fit_equals_the_eager_loop(cuda_device):
    x, y, noise = _flagship_inputs(86, cuda_device)
    want = _eager(x, y, noise, 60)
    bt.reset_launch_counts()
    got = gp_ops.fit_gp_batch_chunked(x, y, noise, n_optim_nits=60, chunk_steps=25)
    _assert_same_fit(got, (want[0], want[2]))
    assert bt.fit_replay_counts() == {"adam": 60 - 3 * WARMUP}  # segments of 25, 25 and 10


@pytest.mark.gpu
def test_warm_time_graphed_fit_equals_the_eager_loop(cuda_device):
    x, y, noise = _flagship_inputs(165, cuda_device)
    coarse = _eager(x[:, ::12].contiguous(), y[:, ::12].contiguous(),
                    noise[:, ::12].contiguous(), 40)
    fine = _eager(x, y, noise, 20, init=coarse[0])
    got = gp_ops.fit_gp_batch_warm_time(x, y, noise, time_stride=12, coarse_steps=40,
                                        fine_steps=20)
    _assert_same_fit(got, (fine[0], torch.cat([coarse[2], fine[2]], dim=1)))


@pytest.mark.gpu
def test_a_graphed_fit_counts_what_the_eager_loop_launches(cuda_device):
    x, y, noise = _flagship_inputs(165, cuda_device)
    bt.reset_launch_counts()
    _eager(x, y, noise, 30)
    eager = bt.launch_counts(), bt.route_counts()
    bt.reset_launch_counts()
    with profiling.recording() as rec:
        gp_ops.fit_gp_batch(x, y, noise, n_optim_nits=30)
    assert (bt.launch_counts(), bt.route_counts()) == eager
    assert eager[0]["chol_solve"] == eager[0]["tri_inv"] == 30
    assert bt.fit_step_counts() == {"adam": 30, "bfgs": 0, "lbfgs": 0}
    assert bt.fit_replay_counts() == {"adam": 30 - WARMUP}
    (loop,) = rec.spans
    assert loop.name == "fit.loop" and loop.attrs["replays"] == 30 - WARMUP
    assert loop.device_ms is not None and loop.device_ms > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, route", [
    (112, 165, "kernel"),  # the annual historical fit
    (64, 250, "blocked"),  # the recursive blocked NLML
])
def test_graphed_fit_on_the_gram_kernels_equals_the_eager_loop(cuda_device, b, t, route):
    """On a card the Matern-3/2 step builds its Gram and contracts its
    gradient with the Gram kernels (``ops/gram.py``), in the eager loop and
    in the graph alike, one of each an Adam step; the two agree bit for
    bit."""
    x, y, noise = _random_inputs(b, t, torch.float32, cuda_device)
    assert bt.linalg_path(t, b=b, dtype=torch.float32) == route
    bt.reset_launch_counts()
    want = _eager(x, y, noise, 12)
    eager = bt.launch_counts()
    assert eager["gram_matern32"] == eager["gram_matern32_grad"] == 12
    bt.reset_launch_counts()
    got = gp_ops.fit_gp_batch(x, y, noise, n_optim_nits=12)
    assert bt.launch_counts() == eager
    _assert_same_fit(got, (want[0], want[2]))


@pytest.mark.gpu
def test_the_gram_kernels_count_once_a_replay(cuda_device):
    x, y, noise = _flagship_inputs(86, cuda_device)
    bt.reset_launch_counts()
    gp_ops.fit_gp_batch(x, y, noise, n_optim_nits=40)
    assert bt.fit_replay_counts() == {"adam": 40 - WARMUP}
    counts = bt.launch_counts()
    assert counts["gram_matern32"] == counts["gram_matern32_grad"] == 40
    assert counts["chol_solve"] == counts["tri_inv"] == 40


def test_on_the_cpu_no_step_is_replayed():
    x, y, noise = _random_inputs(3, 20, torch.float64, torch.device("cpu"))
    bt.reset_launch_counts()
    with profiling.recording() as rec:
        gp_ops.fit_gp_batch_chunked(x, y, noise, n_optim_nits=11, chunk_steps=5)
    assert bt.fit_step_counts()["adam"] == 11
    assert bt.fit_replay_counts() == {"adam": 0}
    assert [s.attrs["replays"] for s in rec.spans] == [0, 0, 0]


@pytest.mark.parametrize("optimizer", ["bfgs", "lbfgs"])
def test_other_optimisers_are_never_replayed(optimizer):
    x, y, noise = _random_inputs(3, 20, torch.float64, torch.device("cpu"))
    bt.reset_launch_counts()
    gp_ops.fit_gp_batch(x, y, noise, n_optim_nits=6, optimizer=optimizer)
    assert bt.fit_step_counts()[optimizer] == 6
    assert bt.fit_replay_counts() == {"adam": 0}


def test_reset_launch_counts_resets_the_replay_count():
    gp_ops.FIT_REPLAYS["adam"] = 5
    assert bt.fit_replay_counts() == {"adam": 5}
    bt.reset_launch_counts()
    assert bt.fit_replay_counts() == {"adam": 0}
    assert "fit_replay_counts" in bt.__all__
