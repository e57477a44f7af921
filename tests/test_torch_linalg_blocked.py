"""The port's blocked NLML, Cholesky and linalg route table against the JAX
package, in float64 on the CPU.

Tolerances: both sides factor the same SPD matrices (the blocked sizes use
the JAX test's ``a a^T + T I``, condition number below 10; the Cholesky the
Matern-3/2 Grams of test_torch_linalg.py, below 1e3) by backward-stable
algorithms in float64, so values agree to 1e-9 relative to the largest entry
(the JAX blocked test's own tolerance) and gradients to 1e-8.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import gp as jgp
from bayesian_ensembling_tpu.ops import linalg_blocked as jlb
from bayesian_ensembling_tpu.ops import linalg_pallas as jlp
from bayesian_ensembling_tpu_torch import _build, reset_launch_counts, route_counts
from bayesian_ensembling_tpu_torch.ops import gp as tgp
from bayesian_ensembling_tpu_torch.ops import linalg_blocked as tlb
from bayesian_ensembling_tpu_torch.ops import linalg_cuda as tlc

torch.set_num_threads(1)

RTOL = 1e-9
GTOL = 1e-8


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jlp, "INTERPRET", True)


def spd_batch(rng, b, t):
    a = rng.normal(size=(b, t, t))
    return a @ np.swapaxes(a, -1, -2) + t * np.eye(t)


def make_spd(rng, b, t):
    """Matern-3/2 Grams on sorted 1-D inputs plus noise, as the GP fit sees."""
    x = np.sort(rng.normal(size=(b, t)), axis=1)
    d = np.abs(x[:, :, None] - x[:, None, :]) / 1.3
    k = (1.0 + np.sqrt(3.0) * d) * np.exp(-np.sqrt(3.0) * d)
    return k + rng.uniform(0.05, 0.2, size=(b, t))[:, :, None] * np.eye(t)


def close(got, want, rtol=RTOL):
    got = np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _loss_weights(rng, b):
    return rng.uniform(0.5, 1.5, size=b), rng.uniform(0.5, 1.5, size=b)


@pytest.mark.parametrize(
    ("t", "nb"),
    [
        (64, 64),  # a single base-case block
        (100, 64),  # one padded block
        (150, 64),  # two blocks and identity-tail padding mid-recursion
        (300, 64),  # several levels, padded
        (200, 128),  # an uneven split at the production block size
    ],
)
def test_nlml_terms_blocked_value_and_grad_match_jax(t, nb):
    rng = np.random.default_rng(t + nb)
    b = 2
    k = spd_batch(rng, b, t)
    y = rng.normal(size=(b, t))
    cq, cl = _loss_weights(rng, b)

    def jloss(ky, yy):
        q, ld = jlb.nlml_terms_blocked(ky, yy, nb)
        return jnp.sum(cq * q + cl * ld), (q, ld)

    (_, (jq, jld)), (jg_k, jg_y) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(k), jnp.asarray(y)
    )
    tk = torch.from_numpy(k.copy()).requires_grad_(True)
    ty = torch.from_numpy(y.copy()).requires_grad_(True)
    q, ld = tlb.nlml_terms_blocked(tk, ty, nb)
    loss = torch.sum(torch.from_numpy(cq) * q + torch.from_numpy(cl) * ld)
    g_k, g_y = torch.autograd.grad(loss, (tk, ty))
    close(q.detach().numpy(), jq)
    close(ld.detach().numpy(), jld)
    close(g_k.numpy(), jg_k, GTOL)
    close(g_y.numpy(), jg_y, GTOL)


@pytest.mark.parametrize("path", ["kernel", "library"])
@pytest.mark.filterwarnings("ignore:batched linalg")
def test_nlml_terms_routes_match_jax(monkeypatch, path):
    """Both non-blocked routes of nlml_terms give the JAX values and custom
    gradient (on the CPU the kernel route runs the kernels' plain versions);
    the library route is taken by cutting the float64 cap below T."""
    rng = np.random.default_rng(3)
    b, t = 3, 20
    if path == "library":
        monkeypatch.setitem(tlc.KERNEL_T_CAP, torch.float64, t - 1)
    k = make_spd(rng, b, t)
    y = rng.normal(size=(b, t))
    cq, cl = _loss_weights(rng, b)

    def jloss(ky, yy):
        q, ld = jlp.nlml_terms(ky, yy)
        return jnp.sum(cq * q + cl * ld)

    jval, (jg_k, jg_y) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(y))
    tk = torch.from_numpy(k.copy()).requires_grad_(True)
    ty = torch.from_numpy(y.copy()).requires_grad_(True)
    reset_launch_counts()
    q, ld = tlc.nlml_terms(tk, ty)
    loss = torch.sum(torch.from_numpy(cq) * q + torch.from_numpy(cl) * ld)
    g_k, g_y = torch.autograd.grad(loss, (tk, ty))
    # One routed factorisation forward and one triangular inverse backward.
    assert route_counts() == {r: 2 * (r == path) for r in ("kernel", "blocked", "library")}
    close(loss.item(), float(jval))
    close(g_k.numpy(), jg_k, GTOL)
    close(g_y.numpy(), jg_y, GTOL)


@pytest.mark.parametrize(("t", "nb"), [(150, 64), (100, 32), (40, 16)])
def test_rec_inv_logdiag_matches_numpy_inverse(t, nb):
    rng = np.random.default_rng(t)
    b = 2
    k = spd_batch(rng, b, t)
    a, t_orig = tlb._pad_to_block(torch.from_numpy(k), nb)
    assert a.shape[-1] % nb == 0 and t_orig == t
    w, sld = tlb._rec_inv_logdiag(a, nb)
    l = np.linalg.cholesky(k)
    close(w[:, :t, :t].numpy(), np.linalg.inv(l))
    # The identity tail is its own inverse and adds log(1) = 0.
    close(w[:, t:, t:].numpy(), np.broadcast_to(np.eye(a.shape[-1] - t), (b, a.shape[-1] - t, a.shape[-1] - t)))
    close(sld.numpy(), np.log(np.diagonal(l, axis1=-2, axis2=-1)).sum(axis=-1))


def test_blocked_leaf_count_at_monthly_ssp_size(monkeypatch):
    """At T = 1032 (padded to 1152 = 9 blocks of 128) the recursion has 9
    leaves: one Cholesky and one triangular inverse each."""
    leaves = []
    monkeypatch.setattr(tlb, "_diag_chol", lambda a: leaves.append(a.shape[-1]) or torch.eye(a.shape[-1]).expand_as(a))
    monkeypatch.setattr(tlb, "_diag_tri_inv", lambda l: l)
    a, _ = tlb._pad_to_block(torch.eye(1032)[None], tlb.DEFAULT_BLOCK)
    tlb._rec_inv_logdiag(a, tlb.DEFAULT_BLOCK)
    assert a.shape[-1] == 1152 and leaves == [128] * 9


@pytest.mark.parametrize("b,t", [(4, 24), (3, 13), (8, 32)])
def test_cholesky_batched_matches_pallas(pallas_interpret, b, t):
    rng = np.random.default_rng(b + t)
    k_tlb = np.ascontiguousarray(make_spd(rng, b, t).transpose(1, 2, 0))
    want = jlp.cholesky_batched(jnp.asarray(k_tlb))
    got = tlc.cholesky_batched(torch.from_numpy(k_tlb))
    assert got.shape == (t, t, b)
    close(got.numpy(), want)


def test_chol_non_pd_gives_nan_in_its_slot_only():
    rng = np.random.default_rng(4)
    k = make_spd(rng, 3, 12)
    k[1] = -np.eye(12)
    l = tlc.chol(torch.from_numpy(k))
    assert torch.isnan(l[1].diagonal()).all()
    assert torch.isfinite(l[[0, 2]]).all()


@pytest.mark.parametrize(
    ("t", "b", "dtype", "route"),
    [
        (165, None, torch.float32, "kernel"),  # annual historical
        (86, 112, torch.float32, "kernel"),  # annual SSP batch
        (239, 28, torch.float32, "kernel"),  # the float32 cap
        (240, 28, torch.float32, "blocked"),
        (240, 4, torch.float32, "library"),  # the examples' fits: B below BLOCKED_MIN_BATCH
        (1032, 65, torch.float32, "blocked"),  # monthly SSP fit
        (1032, 27, torch.float32, "library"),  # batch below BLOCKED_MIN_BATCH
        (1980, 28, torch.float32, "blocked"),  # monthly historical chunk: BLOCKED_MIN_BATCH
        (1980, 27, torch.float32, "library"),
        (1980, 16, torch.float32, "library"),  # the library API's batches, B <= 16
        (3012, 28, torch.float32, "blocked"),  # BLOCKED_T_CAP: 1850-2100 monthly
        (3013, 28, torch.float32, "library"),
        (1032, None, torch.float32, "library"),  # the posterior: never blocked
        (1032, 65, torch.float64, "library"),  # the f32-only rule
        (167, None, torch.float64, "kernel"),
        (168, 112, torch.float64, "kernel"),  # the float64 cap
        (169, 112, torch.float64, "library"),
        (16, 4, torch.float16, "library"),  # the kernels take f32 and f64 only
    ],
)
@pytest.mark.filterwarnings("ignore:batched linalg")
def test_linalg_path_routes(t, b, dtype, route):
    reset_launch_counts()
    assert tlc.linalg_path(t, b=b, dtype=dtype) == route
    # A decision alone counts nothing; the calls that act on it count.
    assert route_counts() == {"kernel": 0, "blocked": 0, "library": 0}


def test_linalg_path_constants_are_the_h100_gates_and_warn_once(monkeypatch):
    # The blocked route's gates as measured on the H100 (PERF.md section 6),
    # not the JAX package's TPU values; the leaf size stays the JAX package's.
    assert (tlc.BLOCKED_T_CAP, tlc.BLOCKED_MIN_BATCH) == (3012, 28)
    assert (jlp.BLOCKED_T_CAP, jlp.BLOCKED_MIN_BATCH) == (1536, 64)
    assert tlb.DEFAULT_BLOCK == jlb.DEFAULT_BLOCK
    # The caps are the launchers' shared-memory sizes at the H100's limit.
    for dtype, cap in tlc.KERNEL_T_CAP.items():
        e = dtype.itemsize
        assert tlc._kernel_smem_bytes(cap, e) <= _build.SMEM_BYTES < tlc._kernel_smem_bytes(cap + 1, e)
    monkeypatch.setattr(tlc, "_warned_routes", set())
    with pytest.warns(UserWarning, match="blocked NLML"):
        tlc.linalg_path(1000, b=100)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tlc.linalg_path(1000, b=100)  # the same (T, route): no second warning


@pytest.mark.filterwarnings("ignore:batched linalg")
def test_blocked_nlml_matches_the_library_route_past_the_old_cap():
    """Past T = 1536, the JAX package's cap, where the port's blocked route
    still runs (the monthly historical fit, T = 1980): the blocked NLML's
    value and custom gradient equal ``nlml_terms`` on the library route
    (``torch.linalg``) in float64, at B = 3 and T = 1600 (padded to 13
    leaves of 128)."""
    rng = np.random.default_rng(1600)
    b, t = 3, 1600
    k = make_spd(rng, b, t)
    y = rng.normal(size=(b, t))
    cq, cl = _loss_weights(rng, b)
    assert tlc.linalg_path(t, dtype=torch.float64) == "library"
    got, want = [], []
    for nlml, out in ((tlb.nlml_terms_blocked, got), (tlc.nlml_terms, want)):
        tk = torch.from_numpy(k.copy()).requires_grad_(True)
        q, ld = nlml(tk, torch.from_numpy(y))
        loss = torch.sum(torch.from_numpy(cq) * q + torch.from_numpy(cl) * ld)
        (g_k,) = torch.autograd.grad(loss, (tk,))
        out.extend([q.detach().numpy(), ld.detach().numpy(), g_k.numpy()])
    close(got[0], want[0])
    close(got[1], want[1])
    close(got[2], want[2], GTOL)


@pytest.mark.filterwarnings("ignore:batched linalg")
def test_jax_layout_wrappers_take_the_library_route_beyond_the_cap():
    """Beyond the kernels' cap the JAX-layout wrappers use torch.linalg, as
    the JAX package uses XLA there."""
    rng = np.random.default_rng(6)
    b, t = 2, 250
    k = make_spd(rng, b, t)
    y = rng.normal(size=(b, t))
    k_tlb = torch.from_numpy(np.ascontiguousarray(k.transpose(1, 2, 0)))
    reset_launch_counts()
    lt = tlc.cholesky_batched(k_tlb)
    lt2, z, alpha, logdet = tlc.cholesky_solve_fused(k_tlb, torch.from_numpy(y.T.copy()))
    w = tlc.tri_inv_batched(lt)
    assert route_counts()["library"] == 3
    l = np.linalg.cholesky(k)
    close(lt.numpy(), l.transpose(2, 1, 0))
    close(lt2.numpy(), l.transpose(2, 1, 0))
    close(alpha.numpy(), np.linalg.solve(k, y[..., None])[..., 0].T)
    close(logdet.numpy(), np.linalg.slogdet(k)[1])
    close(w.numpy(), np.linalg.inv(l).transpose(1, 2, 0))


def _two_member_monthly_gram(n_real, seed):
    """A monthly SSP model (T = 1032, 29 realisation slots, ``n_real`` real)
    with AR(1) internal variability, and its float32 GP inputs as the fit
    forms them at the scratch initialisation: features, targets (the
    realisation mean), the known noise floored at 1e-8, 1e-6 jitter."""
    t, r = 1032, 29
    rng = np.random.default_rng(seed)
    eps = rng.normal(0.0, 0.15 * np.sqrt(1.0 - 0.81), size=(n_real, t))
    noise = np.empty((n_real, t))
    noise[:, 0] = rng.normal(0.0, 0.15, size=n_real)
    for k in range(1, t):
        noise[:, k] = 0.9 * noise[:, k - 1] + eps[:, k]
    block = np.zeros((1, r, t))
    block[0, :n_real] = 1.0 + 0.0025 * np.arange(1, t + 1) + noise
    b = torch.tensor(block, dtype=torch.float32)
    w = (torch.arange(r) < n_real).to(torch.float32)[None]
    mu = torch.einsum("mrt,mr->mt", b, w) / n_real
    var = torch.einsum("mrt,mr->mt", (b - mu[:, None]) ** 2, w) / n_real
    return b.transpose(1, 2).contiguous(), mu, torch.clamp(var, min=1e-8)


@pytest.mark.parametrize(("n_real", "seed", "fails"), [(2, 0, True), (2, 3, True), (3, 0, False)])
def test_two_member_monthly_gram_fails_float32_blocked_nlml_in_both_packages(n_real, seed, fails):
    """ROADMAP C6, pinned: a two-member model whose known noise reaches the
    1e-8 floor has a float32 Gram at T = 1032 that is not positive definite
    as stored (the round-off of the squared-distance expansion exceeds the
    noise and jitter), so the float32 blocked NLML is NaN in the JAX package
    and in the port alike.  Each package builds its own Gram from the same
    float32 inputs.  A three-member model's noise stays well above the floor,
    and the two packages then agree to 1e-5 relative (float32 round-off of a
    Gram with condition number below 1e7 on a log-determinant near -4e3)."""
    x, y, v = _two_member_monthly_gram(n_real, seed)
    t = x.shape[1]
    pre, apply_fn = tgp.get_kernel_precomputed("matern32")
    with torch.no_grad():
        k = apply_fn(tgp.init_params(1, device="cpu", dtype=torch.float32), pre(x, x))
    ky = k + torch.diag_embed(v) + 1e-6 * torch.eye(t)
    jpre, japply = jgp.get_kernel_precomputed("matern32")
    jx = jnp.asarray(x[0].numpy())
    jk = japply(jgp.init_params(dtype=jnp.float32), jpre(jx, jx))
    jky = jk + jnp.diag(jnp.asarray(v[0].numpy())) + 1e-6 * jnp.eye(t, dtype=jnp.float32)
    tq, tld = tlb.nlml_terms_blocked(ky, y)
    jq, jld = jlb.nlml_terms_blocked(jky[None], jnp.asarray(y.numpy()))
    got = np.array([tq.item(), tld.item()])
    want = np.array([float(jq[0]), float(jld[0])])
    min_eig = np.linalg.eigvalsh(ky[0].double().numpy())[0]
    if fails:
        assert float(v.min()) == pytest.approx(1e-8)
        assert min_eig < 0.0
        assert np.isnan(got).all() and np.isnan(want).all()
    else:
        assert min_eig > 0.0
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.filterwarnings("ignore:batched linalg")
def test_fit_warns_when_a_model_goes_non_finite(monkeypatch):
    """The float32 fit of the two-member model of ROADMAP C6 on the blocked
    route (the batch gate cut to 1) names the model whose loss went NaN."""
    monkeypatch.setattr(tlc, "BLOCKED_MIN_BATCH", 1)
    x, y, v = _two_member_monthly_gram(2, 0)
    with pytest.warns(UserWarning, match=r"model\(s\) \[0\] of 1 went non-finite at T=1032"):
        _, losses = tgp.fit_gp_batch(x, y, v, n_optim_nits=2)
    assert torch.isnan(losses).all()
    x3, y3, v3 = _two_member_monthly_gram(3, 0)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="fit_gp_batch")
        _, losses = tgp.fit_gp_batch(x3, y3, v3, n_optim_nits=2)
    assert torch.isfinite(losses).all()
