"""The port's Cholesky-solve, triangular inverse and NLML terms against the
JAX package's Pallas kernels in interpret mode, in float64.

Tolerances: both sides factor the same well-conditioned matrices (condition
number below 1e3) by different but backward-stable algorithms, so outputs
agree to 1e-10 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bayesian_ensembling_tpu.ops import linalg_pallas as jlp
from bayesian_ensembling_tpu_torch.ops import linalg_cuda as tlc

torch.set_num_threads(1)

RTOL = 1e-10


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jlp, "INTERPRET", True)


def make_spd(rng, b, t):
    """Matern-3/2 Grams on sorted 1-D inputs plus noise, as the GP fit sees."""
    x = np.sort(rng.normal(size=(b, t)), axis=1)
    d = np.abs(x[:, :, None] - x[:, None, :]) / 1.3
    k = (1.0 + np.sqrt(3.0) * d) * np.exp(-np.sqrt(3.0) * d)
    noise = rng.uniform(0.05, 0.2, size=(b, t))
    return k + noise[:, :, None] * np.eye(t)


def close(got, want, rtol=RTOL):
    got = np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("b,t", [(4, 24), (3, 13), (8, 32)])
def test_cholesky_solve_fused_matches_pallas(pallas_interpret, b, t):
    rng = np.random.default_rng(b * t)
    k = make_spd(rng, b, t)
    y = rng.normal(size=(b, t))
    k_tlb = np.ascontiguousarray(k.transpose(1, 2, 0))
    want = jlp.cholesky_solve_fused(jnp.asarray(k_tlb), jnp.asarray(y.T))
    got = tlc.cholesky_solve_fused(torch.from_numpy(k_tlb), torch.from_numpy(y.T.copy()))
    assert got[0].shape == (t, t, b) and got[1].shape == (t, b) and got[3].shape == (b,)
    for g, w in zip(got, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("b,t", [(4, 24), (2, 13)])
def test_tri_inv_batched_matches_pallas(pallas_interpret, b, t):
    rng = np.random.default_rng(7 + t)
    k = make_spd(rng, b, t)
    lt = np.linalg.cholesky(k).transpose(2, 1, 0).copy()  # L^T layout (T, T, B)
    want = jlp.tri_inv_batched(jnp.asarray(lt))
    got = tlc.tri_inv_batched(torch.from_numpy(lt))
    assert got.shape == (t, t, b)
    close(got.numpy(), want)


def test_non_pd_gives_nan(pallas_interpret):
    rng = np.random.default_rng(1)
    k = make_spd(rng, 3, 12)
    k[1] = -np.eye(12)  # not positive definite
    y = rng.normal(size=(3, 12))
    l, z, alpha, logdet = tlc.chol_solve(torch.from_numpy(k), torch.from_numpy(y))
    assert torch.isnan(logdet[1]) and torch.isnan(alpha[1]).all() and torch.isnan(z[1]).all()
    assert torch.isfinite(logdet[[0, 2]]).all() and torch.isfinite(alpha[[0, 2]]).all()
    # The JAX package's Pallas kernel fails the same way.
    _, _, w_alpha, w_logdet = jlp.cholesky_solve_fused(
        jnp.asarray(k.transpose(1, 2, 0)), jnp.asarray(y.T)
    )
    assert np.isnan(np.asarray(w_logdet)[1]) and np.isnan(np.asarray(w_alpha)[:, 1]).all()


@pytest.mark.parametrize("b,t", [(3, 16), (2, 9)])
def test_nlml_terms_value_and_grad_match_jax(pallas_interpret, b, t):
    rng = np.random.default_rng(11 * t)
    k = make_spd(rng, b, t)
    y = rng.normal(size=(b, t))
    cq = rng.uniform(0.5, 1.5, size=b)
    cl = rng.uniform(0.5, 1.5, size=b)

    def jloss(ky, yy):
        q, ld = jlp.nlml_terms(ky, yy)
        return jnp.sum(cq * q + cl * ld)

    jval, (jg_k, jg_y) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(y))

    tk = torch.from_numpy(k.copy()).requires_grad_(True)
    ty = torch.from_numpy(y.copy()).requires_grad_(True)
    q, ld = tlc.nlml_terms(tk, ty)
    loss = torch.sum(torch.from_numpy(cq) * q + torch.from_numpy(cl) * ld)
    g_k, g_y = torch.autograd.grad(loss, (tk, ty))
    close(loss.item(), float(jval))
    close(g_k.numpy(), jg_k)
    close(g_y.numpy(), jg_y)

    # The same gradient through torch.linalg's own autograd (symmetrised:
    # autograd of cholesky returns the symmetric part of the gradient).
    tk2 = torch.from_numpy(k.copy()).requires_grad_(True)
    ty2 = torch.from_numpy(y.copy()).requires_grad_(True)
    chol = torch.linalg.cholesky(tk2)
    alpha = torch.cholesky_solve(ty2[..., None], chol)[..., 0]
    q2 = torch.sum(ty2 * alpha, dim=-1)
    ld2 = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    loss2 = torch.sum(torch.from_numpy(cq) * q2 + torch.from_numpy(cl) * ld2)
    g_k2, g_y2 = torch.autograd.grad(loss2, (tk2, ty2))
    sym = 0.5 * (g_k + g_k.mT)
    close(sym.numpy(), (0.5 * (g_k2 + g_k2.mT)).numpy())
    close(g_y.numpy(), g_y2.numpy())


def test_core_shape_checks():
    with pytest.raises(ValueError, match=r"\(B, T, T\)"):
        tlc.chol_solve(torch.zeros((2, 3, 4)), torch.zeros((2, 3)))
    with pytest.raises(ValueError, match=r"\(B, T, T\)"):
        tlc.tri_inv(torch.zeros((2, 3, 4)))
