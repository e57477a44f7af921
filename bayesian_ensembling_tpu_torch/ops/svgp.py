"""Sparse variational GP (SVGP) with known heteroskedastic noise.

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/svgp.py``: additive
Matern-3/2 kernels over feature groups (xy / z / time / realisations),
linspace-initialised inducing points, whitened variational parameters
(u = Lz v), the closed-form variational expectation of the known per-point
noise, and minibatched Adam (``ops/gp._Adam``, the update of
``optax.adam``) on the negative ELBO.  The inducing Gram's Cholesky is
``torch.linalg.cholesky_ex``, as the JAX package's is XLA's.

Minibatches are drawn with replacement, one per step, from a CPU
``torch.Generator`` seeded from ``(seed, absolute step index)``
(:func:`_minibatch_indices`): the draw is the same on the card and on the
CPU, and the same however the run is chunked.  JAX's threefry draws
(``jax.random.randint(fold_in(key, i))``) cannot be reproduced; the tests
put them in that one helper.
"""

from __future__ import annotations

import logging
import math
import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch.ops.gp import _Adam, _sq_dists

__all__ = ["fit_predict_svgp", "default_feature_groups"]

_LOG_2PI = 1.8378770664093453
_SQRT3 = 1.7320508075688772
_NAMES = ("raw_ls", "raw_var", "z", "m", "ls_flat")


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` operation for operation, ``max(x, 0) +
    log1p(exp(-|x|))``, with its derivative ``exp(x - softplus(x))``.

    The SVGP needs JAX's rounding: softplus of softplus^-1(1) is exactly 1
    there (``torch.logaddexp`` gives 1 - 2^-53), so the whitened square root
    starts as the identity and, at that start, the gradients of the
    lengthscales and the inducing points cancel to exactly zero.  Adam
    divides each step by the root of its second moment, so round-off left
    there instead becomes a step of up to the learning rate in a direction
    set by the round-off (measured on a 5,504-point fit: 0.05 degC between
    two float64 runs that differ only in their BLAS thread count)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad * torch.exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def default_feature_groups(n_features: int) -> tp.Tuple[tp.Tuple[int, ...], ...]:
    """The reference's grouping: xy, z, time, realisations."""
    if n_features < 4:
        raise ValueError(
            f"default_feature_groups needs >= 4 features (xy, z, time), "
            f"got {n_features}; pass explicit groups for other layouts"
        )
    groups: tp.List[tp.Tuple[int, ...]] = [(0, 1), (2,), (3,)]
    if n_features > 4:
        groups.append(tuple(range(4, n_features)))
    return tuple(groups)


def _additive_matern32(params, x1, x2, groups):
    """Sum over feature groups of Matern-3/2 kernels, each on its group's
    columns with its own softplus lengthscale and variance; the distance is
    ``ops/gp``'s (``sqrt(d^2 + 1e-36)``, d^2 clipped at 0)."""
    total = 0.0
    for g, idx in enumerate(groups):
        cols = list(idx)
        d2 = _sq_dists(x1[None, :, cols], x2[None, :, cols])[0]
        r = torch.sqrt(d2 + 1e-36) / softplus(params["raw_ls"][g])
        total = total + softplus(params["raw_var"][g]) * (1.0 + _SQRT3 * r) * torch.exp(-_SQRT3 * r)
    return total


def _amplitude(params, groups):
    """Kernel amplitude = the Gram diagonal value (sum of group variances)."""
    total = 0.0
    for g, _ in enumerate(groups):
        total = total + softplus(params["raw_var"][g])
    return total


def _kdiag(params, x, groups):
    return torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device) + _amplitude(params, groups)


def _marginals(params, x, groups, jitter):
    """Whitened SVGP predictive marginals at ``x``: ``(mean, var)``.

    ``jitter`` is relative to the kernel amplitude: in float32 the rounding
    error of the (P, P) Gram scales with its amplitude, and the linspace
    inducing grid packs points close enough that the float32 Gram is
    indefinite at initialisation under a fixed absolute jitter."""
    z = params["z"]
    p = z.shape[0]
    kzz = _additive_matern32(params, z, z, groups) + (
        jitter * _amplitude(params, groups)
    ) * torch.eye(p, dtype=z.dtype, device=z.device)
    lz, _ = torch.linalg.cholesky_ex(kzz)
    kzx = _additive_matern32(params, z, x, groups)  # (P, B)
    a = torch.linalg.solve_triangular(lz, kzx, upper=False).T  # (B, P)
    mean = a @ params["m"]
    asl = a @ _ls_matrix(params)
    var = (
        _kdiag(params, x, groups)
        - torch.sum(torch.square(a), dim=1)
        + torch.sum(torch.square(asl), dim=1)
    )
    return mean, torch.clamp(var, min=1e-12)


def _ls_matrix(params):
    """Lower-triangular square root of the whitened variational covariance:
    ``ls_flat`` row-major into the lower triangle, softplus on the diagonal."""
    p = params["m"].shape[0]
    rows, cols = torch.tril_indices(p, p, device=params["m"].device)
    tri = torch.zeros((p, p), dtype=params["m"].dtype, device=params["m"].device)
    tri = tri.index_put((rows, cols), params["ls_flat"])
    diag = torch.diagonal(tri)
    return tri - torch.diag(diag) + torch.diag(softplus(diag))


def _kl(params):
    """KL(q(v) || N(0, I)) in whitened coordinates."""
    ls_mat = _ls_matrix(params)
    p = params["m"].shape[0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(ls_mat)))
    return 0.5 * (
        torch.sum(torch.square(params["m"]))
        + torch.sum(torch.square(ls_mat))
        - p
        - logdet
    )


def _svgp_init(x: torch.Tensor, p: int) -> tp.Dict[str, torch.Tensor]:
    """Initial parameters: linspace inducing points through the features'
    range, identity whitened variational square root, zero mean."""
    d = x.shape[1]
    ng = len(default_feature_groups(d))
    like = dict(dtype=x.dtype, device=x.device)
    one = math.log(math.expm1(1.0))  # softplus^-1(1)
    lo = torch.amin(x, dim=0)
    hi = torch.amax(x, dim=0)
    frac = torch.linspace(0.0, 1.0, p, **like)[:, None]
    rows, cols = torch.tril_indices(p, p, device=x.device)
    return {
        "raw_ls": torch.full((ng,), one, **like),
        "raw_var": torch.full((ng,), one, **like),
        "z": lo[None, :] + frac * (hi - lo)[None, :],
        "m": torch.zeros((p,), **like),
        "ls_flat": (rows == cols).to(x.dtype) * one,
    }


def _fold(seed: int, step: int) -> int:
    """A 63-bit generator seed from ``(seed, absolute step index)``
    (SplitMix64's finaliser of the pair)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


def _minibatch_indices(seed: int, start: int, n_steps: int, batch: int, n: int) -> torch.Tensor:
    """``(n_steps, batch)`` indices into ``n`` points, drawn with
    replacement; row ``i`` is step ``start + i``'s minibatch, from a CPU
    generator seeded by ``(seed, start + i)`` alone, so a run split into
    chunks draws what one monolithic run draws, on any device."""
    out = torch.empty((n_steps, batch), dtype=torch.int64)
    gen = torch.Generator()
    for i in range(n_steps):
        gen.manual_seed(_fold(seed, start + i))
        out[i] = torch.randint(0, n, (batch,), generator=gen)
    return out


def _svgp_run_chunk(x, y, noise_var, params, opt, indices, jitter):
    """Advance the minibatched ELBO ascent by one Adam step per row of
    ``indices`` ``(n_steps, batch)``, updating ``params`` and ``opt`` in
    place; returns the negative ELBO at each step's iterate."""
    n = x.shape[0]
    groups = default_feature_groups(x.shape[1])
    scale = n / indices.shape[1]
    leaves = [params[k] for k in _NAMES]
    losses = torch.empty((indices.shape[0],), dtype=x.dtype, device=x.device)
    for i in range(indices.shape[0]):
        idx = indices[i]
        xb, yb, nv = x[idx], y[idx], noise_var[idx]
        mean, fvar = _marginals(params, xb, groups, jitter)
        varexp = -0.5 * (_LOG_2PI + torch.log(nv) + (torch.square(yb - mean) + fvar) / nv)
        loss = -(scale * torch.sum(varexp) - _kl(params))
        grads = torch.autograd.grad(loss, leaves)
        opt.step(leaves, grads)
        losses[i] = loss.detach()
    return losses


@torch.no_grad()
def _svgp_predict(params, x, jitter):
    return _marginals(params, x, default_feature_groups(x.shape[1]), jitter)


def fit_predict_svgp(
    x: torch.Tensor,  # (N, D)
    y: torch.Tensor,  # (N,)
    noise_var: torch.Tensor,  # (N,) known heteroskedastic noise
    n_inducing: int = 400,
    minibatch_size: int = 500,
    n_optim_nits: int = 500,
    learning_rate: float = 0.01,
    jitter: float = 1e-4,
    seed: int = 0,
    chunk_steps: int = 8192,
    return_losses: bool = False,
) -> tp.Tuple[torch.Tensor, ...]:
    """Fit the SVGP on the device of ``x`` and return the latent posterior
    marginals ``(mean (N,), var (N,))`` at the training inputs (the caller
    adds the noise variance back).

    ``n_optim_nits`` Adam steps, run as a host loop of ``chunk_steps``-step
    segments: each segment's minibatch indices are drawn in one go on the
    host (:func:`_minibatch_indices`) and copied to the device once.
    ``return_losses`` also returns the per-step negative ELBO trace as a
    numpy array.
    """
    from bayesian_ensembling_tpu_torch.utils.logging import get_logger

    logger = get_logger("bayesian_ensembling_tpu_torch.svgp")
    n = x.shape[0]
    p = min(n_inducing, n)
    minibatch_size = min(minibatch_size, n)
    params = {k: v.requires_grad_() for k, v in _svgp_init(x, p).items()}
    opt = _Adam([params[k] for k in _NAMES], learning_rate)
    done = 0
    traces = []
    while done < n_optim_nits:
        k = min(chunk_steps, n_optim_nits - done)
        indices = _minibatch_indices(seed, done, k, minibatch_size, n).to(x.device)
        losses = _svgp_run_chunk(x, y, noise_var, params, opt, indices, jitter)
        done += k
        if return_losses:
            traces.append(losses.cpu().numpy())
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("svgp chunk done: step %d/%d, last neg-ELBO %.4f",
                         done, n_optim_nits, float(losses[-1]))
    mean, var = _svgp_predict(params, x, jitter)
    if return_losses:
        return mean, var, np.concatenate(traces) if traces else np.zeros((0,))
    return mean, var
