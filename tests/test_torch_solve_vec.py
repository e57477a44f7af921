"""The port's batched vector solve against the JAX package's, in float64:
the Pallas kernel in interpret mode and its XLA branch.

On the CPU the port's ``solve_vec`` runs its plain version (two triangular
solves and the log of the diagonal); the CUDA kernel is held against the
same plain version on the card (``tests/test_torch_kernels.py``).

Tolerance: both sides substitute through the same well-conditioned factors
(condition number below 1e3) in a different order of additions, so outputs
agree to 1e-10 of the largest entry.
"""

import numpy as np
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


def factors(seed, b, t):
    rng = np.random.default_rng(seed)
    lt = np.linalg.cholesky(make_spd(rng, b, t)).transpose(2, 1, 0).copy()  # (T, T, B) L^T layout
    return lt, rng.normal(size=(t, b))


# T = 13 and 21 are not multiples of 8 (the Pallas kernel pads them with a
# unit diagonal); B = 1 is a single lane.
@pytest.mark.parametrize("b,t", [(4, 24), (3, 13), (1, 21), (8, 32), (1, 1)])
def test_solve_vec_batched_matches_pallas(pallas_interpret, b, t):
    lt, y = factors(b * t, b, t)
    want = jlp._solve_vec_batched_tpu(jnp.asarray(lt), jnp.asarray(y))
    got = tlc.solve_vec_batched(torch.from_numpy(lt), torch.from_numpy(y))
    assert got[0].shape == (t, b) and got[1].shape == (t, b) and got[2].shape == (b,)
    for g, w in zip(got, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("b,t", [(4, 24), (3, 13), (1, 21)])
def test_solve_vec_batched_matches_xla_branch(b, t):
    """``jlp.solve_vec_batched`` off the TPU takes its XLA branch."""
    lt, y = factors(100 + b * t, b, t)
    want = jlp.solve_vec_batched(jnp.asarray(lt), jnp.asarray(y))
    got = tlc.solve_vec_batched(torch.from_numpy(lt), torch.from_numpy(y))
    for g, w in zip(got, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("b,t", [(4, 24), (2, 13)])
def test_core_equals_layout_wrapper_and_solves_the_system(b, t):
    lt, y = factors(7 + t, b, t)
    l = torch.from_numpy(lt).permute(2, 1, 0).contiguous()
    z, alpha, logdet = tlc.solve_vec(l, torch.from_numpy(y.T.copy()))
    zt, at, ld = tlc.solve_vec_batched(torch.from_numpy(lt), torch.from_numpy(y))
    assert torch.equal(z, zt.T) and torch.equal(alpha, at.T) and torch.equal(logdet, ld)
    k = l @ l.mT
    close(torch.einsum("bij,bj->bi", k, alpha).numpy(), y.T)
    close(logdet.numpy(), np.linalg.slogdet(k.numpy())[1])


@pytest.mark.parametrize("b,t", [(4, 24), (3, 13)])
def test_chol_then_solve_vec_equals_cholesky_solve_fused(pallas_interpret, b, t):
    """The composed form (factor, then solve against the factor) gives what
    the fused Cholesky-solve gives, in the port and in the JAX package."""
    rng = np.random.default_rng(31 * t)
    k = make_spd(rng, b, t)
    y = rng.normal(size=(b, t))
    got = tlc.chol_solve_composed(torch.from_numpy(k), torch.from_numpy(y))
    fused = tlc.chol_solve(torch.from_numpy(k), torch.from_numpy(y))
    want = jlp._chol_solve_fused_tpu(jnp.asarray(k.transpose(1, 2, 0)), jnp.asarray(y.T))
    for g, f in zip(got, fused):
        close(g.numpy(), f.numpy())
    close(got[0].permute(2, 1, 0).numpy(), want[0])
    close(got[1].T.numpy(), want[1])
    close(got[2].T.numpy(), want[2])
    close(got[3].numpy(), want[3])


def test_bad_diagonal_is_not_trapped(pallas_interpret):
    """A zero diagonal entry gives non-finite z / alpha and -inf logdet, a
    negative one NaN logdet, in that matrix only; the Pallas kernel fails
    the same way."""
    lt, y = factors(5, 4, 16)
    lt[6, 6, 1] = 0.0
    lt[15, 15, 2] = -1.0
    z, alpha, logdet = tlc.solve_vec_batched(torch.from_numpy(lt), torch.from_numpy(y))
    wz, walpha, wlogdet = (np.asarray(a) for a in
                           jlp._solve_vec_batched_tpu(jnp.asarray(lt), jnp.asarray(y)))
    for zz, aa, ld in ((z.numpy(), alpha.numpy(), logdet.numpy()), (wz, walpha, wlogdet)):
        assert ld[1] == -np.inf and np.isnan(ld[2])
        assert not np.isfinite(zz[:, 1]).all() and not np.isfinite(aa[:, 1]).all()
        assert np.isfinite(zz[:, [0, 3]]).all() and np.isfinite(aa[:, [0, 3]]).all()
        assert np.isfinite(ld[[0, 3]]).all()
    close(z.numpy()[:, [0, 3]], wz[:, [0, 3]])


def test_shape_checks():
    with pytest.raises(ValueError, match=r"\(B, T, T\)"):
        tlc.solve_vec(torch.zeros((2, 3, 4)), torch.zeros((2, 3)))
    with pytest.raises(ValueError, match=r"\(B, T\)"):
        tlc.solve_vec(torch.zeros((2, 3, 3)), torch.zeros((2, 4)))
    assert tlc.SOLVE_VEC_T_CAP[torch.float32] > 1980 and tlc.SOLVE_VEC_T_CAP[torch.float64] > 1980


@pytest.mark.parametrize("b,t", [(4, 24), (1, 165), (3, 13)])
def test_forward_only_entry_is_the_full_launch_forward(b, t):
    """``solve_vec_forward`` returns the full call's z and logdet bit for
    bit (the same kernel with its backward pass off on the card)."""
    lt, y = factors(3 * t + b, b, t)
    l = torch.from_numpy(lt).permute(2, 1, 0).contiguous()
    yb = torch.from_numpy(y.T.copy())
    z, alpha, logdet = tlc.solve_vec(l, yb)
    fz, flogdet = tlc.solve_vec_forward(l, yb)
    assert torch.equal(fz, z) and torch.equal(flogdet, logdet)
    with pytest.raises(ValueError, match=r"\(B, T\)"):
        tlc.solve_vec_forward(l, yb[:, :-1])
    assert "solve_vec_forward" not in tlc.__all__


def test_scores_take_the_forward_only_entry(monkeypatch):
    """The callers that drop alpha (the full-covariance score and
    ``FullCovGaussian.log_prob`` of one vector) never ask for it."""
    from bayesian_ensembling_tpu_torch.ops import distributions, scoring

    def full_solve(*_):
        raise AssertionError("alpha asked for")

    calls = []
    forward = tlc.solve_vec_forward
    monkeypatch.setattr(tlc, "solve_vec", full_solve)
    monkeypatch.setattr(tlc, "solve_vec_forward", lambda l, y: calls.append(l.shape) or forward(l, y))
    rng = np.random.default_rng(9)
    k = make_spd(rng, 3, 12)
    chol = torch.linalg.cholesky(torch.from_numpy(k))
    mean = torch.from_numpy(rng.normal(size=(3, 12)))
    obs = torch.from_numpy(rng.normal(size=(5, 12)))
    ll = scoring.fullcov_constant_vector_log_likelihood(mean, chol, obs)
    assert ll.shape == (3, 5, 12) and torch.isfinite(ll).all() and len(calls) == 2
    dist = distributions.FullCovGaussian(mean[0], torch.from_numpy(k[0]))
    lp = dist.log_prob(mean[0] + 0.1)
    jittered = torch.from_numpy(k[0] + 1e-10 * np.eye(12))  # FullCovGaussian.chol's jitter
    want = torch.distributions.MultivariateNormal(mean[0], jittered).log_prob(mean[0] + 0.1)
    close(lp.numpy(), want.numpy())
    assert len(calls) == 3
