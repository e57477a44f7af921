"""The Matern-3/2 Gram kernels' plain versions and the NLML terms on them
(``ops/gram.py``), against PyTorch's autograd of the fit's elementwise
chain, in float64 on the CPU (the kernels themselves run in
``tests/test_torch_kernels.py -m gpu``).

Tolerances: the Gram is the chain's own arithmetic, so it and the NLML's
values agree bit for bit.  The gradients differ from autograd of the chain
only in the order of summation, on Grams whose condition number stays below
1e4: 1e-10 relative to the largest term of the sum.
"""

import types

import numpy as np
import pytest
import torch

from bayesian_ensembling_tpu_torch import _build, launch_counts, reset_launch_counts, route_counts
from bayesian_ensembling_tpu_torch.ops import gp as tgp
from bayesian_ensembling_tpu_torch.ops import gram
from bayesian_ensembling_tpu_torch.ops import linalg_blocked as tlb
from bayesian_ensembling_tpu_torch.ops import linalg_cuda as tlc

torch.set_num_threads(1)

GTOL = 1e-10


def fit_inputs(b, t, dtype=torch.float64, seed=0):
    """The fit's hoisted distances of 3-realisation features, targets, noise
    and hyperparameters of ``b`` models at T = ``t``."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(0.1 * rng.normal(size=(b, 3, t)), axis=-1)
    x = torch.as_tensor(np.linspace(0.0, 1.0, t) + walk, dtype=dtype).transpose(1, 2)
    dist = tgp.get_kernel_precomputed("matern32")[0](x, x)
    y = torch.as_tensor(rng.normal(size=(b, t)), dtype=dtype)
    noise = torch.as_tensor(rng.uniform(0.05, 0.3, size=(b, t)), dtype=dtype)
    ls = torch.as_tensor(rng.uniform(0.3, 2.0, size=b), dtype=dtype)
    var = torch.as_tensor(rng.uniform(0.5, 2.0, size=b), dtype=dtype)
    return dist, y, noise, ls, var


def chain_gram(dist, ls, var, noise, jitter):
    """The Gram as ``ops/gp._build_batch_step`` builds it on the CPU."""
    params = types.SimpleNamespace(lengthscale=ls, variance=var)
    t = dist.shape[-1]
    _, apply_fn = tgp.get_kernel_precomputed("matern32")
    return (apply_fn(params, dist) + torch.diag_embed(noise)
            + jitter * torch.eye(t, dtype=dist.dtype))


def chain_terms(route, ky, y):
    return tlb.nlml_terms_blocked(ky, y) if route == "blocked" else tlc.nlml_terms(ky, y)


def rel(got, want, scale):
    return float((got - want).abs().max() / scale)


@pytest.mark.parametrize("t", [5, 86, 165])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_reference_is_the_chain_bit_for_bit(t, dtype):
    dist, _, noise, ls, var = fit_inputs(3, t, dtype)
    want = chain_gram(dist, ls, var, noise, 1e-6)
    assert torch.equal(gram.gram_matern32_reference(dist, ls, var, noise, 1e-6), want)
    assert torch.equal(gram.gram_matern32(dist, ls, var, noise, 1e-6), want)


# T = 200 pads to 256 on the blocked route (two leaves of 128).
@pytest.mark.parametrize("t,route", [(5, "kernel"), (86, "kernel"), (165, "kernel"),
                                     (200, "blocked")])
def test_grad_reference_matches_autograd_of_the_chain(t, route):
    dist, y, noise, ls, var = fit_inputs(4, t)
    g_quad = torch.tensor([0.5, 1.0, 0.25, 2.0], dtype=torch.float64)
    g_logdet = torch.tensor([0.5, 0.75, 1.5, 1.0], dtype=torch.float64)
    ls_, var_ = ls.clone().requires_grad_(True), var.clone().requires_grad_(True)
    quad, logdet = chain_terms(route, chain_gram(dist, ls_, var_, noise, 1e-6), y)
    want = torch.autograd.grad((g_quad * quad + g_logdet * logdet).sum(), (ls_, var_))

    ky = chain_gram(dist, ls, var, noise, 1e-6)
    forward, kinv_of = tlb.nlml_route(route)
    _, _, factor, alpha = forward(ky, y)
    kinv = kinv_of(factor)
    got = gram.gram_matern32_grad_reference(kinv, alpha, g_quad, g_logdet, dist, ls, var)
    same = gram.gram_matern32_grad(kinv, alpha, g_quad, g_logdet, dist, ls, var)
    assert all(torch.equal(a, b) for a, b in zip(got, same))
    # The largest term of each sum bounds its round-off.
    g_ky = tlc.nlml_g_ky(kinv, alpha, g_quad, g_logdet)
    scale = float(g_ky.abs().amax() * var.amax() / ls.amin() * t * t)
    for g, w_ in zip(got, want):
        assert rel(g, w_, scale) < GTOL


# The kernel route (B2 and B3's plain versions), the library route (T
# beyond the float64 kernels' cap of 168) and the blocked route (T = 200,
# padded to 256).
@pytest.mark.parametrize("t,route", [(86, "kernel"), (170, "library"), (200, "blocked")])
def test_nlml_terms_on_the_gram_match_the_chain_on_every_route(t, route):
    assert route == "blocked" or tlc.linalg_path(t, b=4, dtype=torch.float64) == route
    dist, y, noise, ls, var = fit_inputs(4, t, seed=3)
    reset_launch_counts()
    grads = []
    for use_gram in (False, True):
        ls_, var_ = ls.clone().requires_grad_(True), var.clone().requires_grad_(True)
        y_ = y.clone().requires_grad_(True)
        if use_gram:
            quad, logdet = gram.matern32_nlml_terms(dist, ls_, var_, noise, y_, 1e-6, route)
        else:
            quad, logdet = chain_terms(route, chain_gram(dist, ls_, var_, noise, 1e-6), y_)
        (0.5 * (quad + logdet)).sum().backward()
        grads.append((quad.detach(), logdet.detach(), ls_.grad, var_.grad, y_.grad))
    chain, on_gram = grads
    for got, want in zip(on_gram[:2], chain[:2]):
        assert torch.equal(got, want)
    for got, want in zip(on_gram[2:], chain[2:]):
        assert rel(got, want, float(want.abs().max())) < 1e-9
    assert torch.equal(on_gram[4], chain[4])  # d quad / dy: the same formula
    # Both runs count their route the same way, and the plain versions launch nothing.
    n = {"kernel": (4, 0, 0), "library": (0, 0, 4), "blocked": (0, 2, 0)}[route]
    assert route_counts() == dict(zip(("kernel", "blocked", "library"), n))
    assert sum(launch_counts().values()) == 0


@pytest.mark.parametrize("t,route", [(86, "kernel"), (170, "library"), (200, "blocked")])
def test_nlml_route_maps_each_route_to_its_forward_and_kinv(t, route):
    """``linalg_blocked.nlml_route``: the forward counts its route once and
    gives the route's NLML values bit for bit, and K^-1 of its factor is the
    inverse of the Gram."""
    dist, y, noise, ls, var = fit_inputs(3, t, seed=5)
    ky = chain_gram(dist, ls, var, noise, 1e-6)
    forward, kinv_of = tlb.nlml_route(route)
    reset_launch_counts()
    quad, logdet, factor, alpha = forward(ky, y)
    assert route_counts() == {r: int(r == route) for r in ("kernel", "blocked", "library")}
    want = chain_terms(route, ky, y)
    assert torch.equal(quad, want[0]) and torch.equal(logdet, want[1])
    eye = torch.eye(t, dtype=ky.dtype).expand_as(ky)
    assert float((kinv_of(factor) @ ky - eye).abs().max()) < 1e-8
    assert float((ky @ alpha[..., None] - y[..., None]).abs().max()) < 1e-8


def test_nlml_terms_on_the_gram_without_a_gradient():
    """The BFGS proposal's value-only evaluation, under ``no_grad``."""
    dist, y, noise, ls, var = fit_inputs(2, 30)
    with torch.no_grad():
        got = gram.matern32_nlml_terms(dist, ls, var, noise, y, 1e-6, "kernel")
        want = tlc.nlml_terms(chain_gram(dist, ls, var, noise, 1e-6), y)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("optimizer", ["adam", "bfgs", "lbfgs"])
def test_the_cpu_fit_keeps_the_chain(monkeypatch, optimizer):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU fit must not take the Gram kernels' path")

    monkeypatch.setattr(gram, "matern32_nlml_terms", refuse)
    dist, y, noise, _, _ = fit_inputs(3, 12)
    x = torch.randn((3, 12, 2), dtype=torch.float64)
    _, losses = tgp.fit_gp_batch(x, y, noise, n_optim_nits=3, optimizer=optimizer)
    assert torch.isfinite(losses).all()


# 512 elements a range: T = 22 is the last one-range matrix (484 elements).
@pytest.mark.parametrize("t,chunks", [(1, 1), (22, 1), (23, 2), (86, 15), (165, 54),
                                      (1032, 2081), (1980, 7658)])
def test_the_ranges_depend_on_t_alone(t, chunks):
    assert gram._chunks(t) == chunks


def _fast_div(d):
    """``make_fast_div`` of ``csrc/gram_matern32.cu``."""
    shift = 0
    while shift < 32 and (1 << shift) < d:
        shift += 1
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


@pytest.mark.parametrize("t", [1, 2, 3, 5, 86, 127, 128, 165, 1032, 1980, 3012, 46340])
def test_the_kernels_row_arithmetic_and_ranges(t):
    """The kernels' index algebra: the multiply-high divider gives each
    flattened offset's row, and the ranges of the warps cover a matrix's
    T x T once, in order."""
    magic, shift = _fast_div(t)
    assert magic < 1 << 32
    tt = t * t
    offsets = np.unique(np.concatenate([np.arange(min(tt, 4096)), np.arange(max(0, tt - 4096), tt),
                                        np.random.default_rng(t).integers(0, tt, 4096)]))
    n = offsets.astype(np.uint64)
    rows = (((n * np.uint64(magic)) >> np.uint64(32)) + n) >> np.uint64(shift)
    np.testing.assert_array_equal(rows, offsets // t)
    chunks = gram._chunks(t)
    length = -(-tt // chunks)
    starts = [min(tt, p * length) for p in range(chunks)]
    ends = [min(tt, s + length) for s in starts]
    assert starts[0] == 0 and ends[-1] == tt
    assert all(e == s for e, s in zip(ends[:-1], starts[1:]))


def test_the_wrappers_refuse_shapes_they_lack():
    dist, y, noise, ls, var = fit_inputs(2, 6)
    with pytest.raises(ValueError, match="distances"):
        gram.gram_matern32(dist[:, :5], ls, var, noise, 1e-6)
    with pytest.raises(ValueError, match="noise"):
        gram.gram_matern32(dist, ls, var, noise[:, :5], 1e-6)
    with pytest.raises(ValueError, match="batch of 2"):
        gram.gram_matern32(dist, ls[:1], var, noise, 1e-6)
    kinv = torch.eye(6, dtype=torch.float64).expand(2, 6, 6)
    with pytest.raises(ValueError, match="alpha"):
        gram.gram_matern32_grad(kinv, y[:, :5], ls, var, dist, ls, var)


def test_the_launch_counters_have_the_gram_kernels():
    assert {"gram_matern32", "gram_matern32_grad"} <= set(_build.LAUNCHES)
    for suffix in ("f32", "f64"):
        assert _build._SIGNATURES[f"bet_gram_matern32_{suffix}"] == (5, 3, 1)
        assert _build._SIGNATURES[f"bet_gram_matern32_grad_{suffix}"] == (10, 3)
