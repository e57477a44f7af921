"""Exact heteroskedastic GP emulation, written from its definition.

Each model is a GP over its T time steps whose inputs are the realisation
vectors ``x_t`` (the realisations time-major, padded realisations zero),
with the Matern-3/2 kernel

    k(x, x') = v (1 + sqrt(3) r) exp(-sqrt(3) r),  r = |x - x'| / l,

the known noise ``diag(n_t)`` (the realisations' population variance,
floored at 1e-8) and a jitter.  Its negative log marginal likelihood is

    nlml = 0.5 (y^T K^-1 y + log|K| + T log 2 pi),  K = k + diag(n) + jitter I,

of the DBA target ``y``, with the gradient

    d nlml / d theta = 0.5 sum_ij (K^-1 - a a^T)_ij (dk / d theta)_ij,  a = K^-1 y.

``l`` and ``v`` are the softplus of two raw parameters, each started at
softplus^-1(1).  The fit runs Adam (optax's update: b1 0.9, b2 0.999, eps
1e-8) or the damped per-model BFGS in the two raw parameters, for a fixed
number of steps, optionally first on every ``time_stride``-th step and then
at full T from there.  The posterior marginals of the latent function at the
training inputs are mean = k a and var_i = k_ii - |(L^-1 k)_{:, i}|^2
(floored at 1e-12), with L the Cholesky factor of K; the emulator's variance
adds the noise back.

Plain PyTorch; every product of two matrices is a ``matmul``, so the
precision it runs in follows the dtype and the TF32 switches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT3 = math.sqrt(3.0)
RAW_INIT = math.log(math.expm1(1.0))  # softplus^-1(1)


def targets_noise(block: torch.Tensor, mask: torch.Tensor):
    """The known noise ``(B, T)``: the population variance of the real
    realisations, floored at 1e-8; and the features ``(B, T, R)``."""
    w = mask.to(block.dtype)
    n = torch.clamp(w.sum(dim=1), min=1.0)[:, None]
    mean = torch.einsum("brt,br->bt", block, w) / n
    var = torch.einsum("brt,br->bt", torch.square(block - mean[:, None, :]), w) / n
    return torch.clamp(var, min=1e-8), block.transpose(1, 2)


def distances(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distances ``(B, T, T)`` between the rows of ``(B, T, D)``."""
    sq = torch.sum(x * x, dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.matmul(x, x.mT)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _kernel(raw: torch.Tensor, dist: torch.Tensor):
    """(k, dk/dl, dk/dv, dl/draw, dv/draw) at raw parameters ``(B, 2)``."""
    ls, var = F.softplus(raw[:, 0]), F.softplus(raw[:, 1])
    r = dist / ls[:, None, None]
    e = torch.exp(-_SQRT3 * r)
    shape = (1.0 + _SQRT3 * r) * e
    k = var[:, None, None] * shape
    dk_dls = 3.0 * var[:, None, None] * r * r * e / ls[:, None, None]
    return k, dk_dls, shape, torch.sigmoid(raw[:, 0]), torch.sigmoid(raw[:, 1])


def _noisy(k, noise, jitter):
    eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    return k + torch.diag_embed(noise) + jitter * eye


def _factor(ky):
    """Cholesky factor; models whose factorisation fails get NaN."""
    l, info = torch.linalg.cholesky_ex(ky)
    return torch.where((info == 0)[:, None, None], l, float("nan"))


def _logdet(l):
    return 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), dim=-1)


def nlml(raw, dist, y, noise, jitter):
    """Per-model NLML ``(B,)``."""
    t = y.shape[-1]
    l = _factor(_noisy(_kernel(raw, dist)[0], noise, jitter))
    z = torch.linalg.solve_triangular(l, y[:, :, None], upper=False)[..., 0]
    return 0.5 * (torch.sum(z * z, dim=-1) + _logdet(l) + t * _LOG_2PI)


def nlml_and_grad(raw, dist, y, noise, jitter):
    """Per-model NLML ``(B,)`` and its gradient in the raw parameters ``(B, 2)``."""
    t = y.shape[-1]
    k, dk_dls, dk_dvar, dls, dvar = _kernel(raw, dist)
    l = _factor(_noisy(k, noise, jitter))
    eye = torch.eye(t, dtype=y.dtype, device=y.device).expand_as(l)
    w = torch.linalg.solve_triangular(l, eye, upper=False)
    kinv = torch.matmul(w.mT, w)
    a = torch.einsum("bij,bj->bi", kinv, y)
    value = 0.5 * (torch.einsum("bi,bi->b", y, a) + _logdet(l) + t * _LOG_2PI)
    inner = kinv - a[:, :, None] * a[:, None, :]
    g_ls = 0.5 * torch.sum(inner * dk_dls, dim=(-2, -1))
    g_var = 0.5 * torch.sum(inner * dk_dvar, dim=(-2, -1))
    return value, torch.stack([g_ls * dls, g_var * dvar], dim=-1)


def adam(raw, n_steps, objective, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """``n_steps`` of Adam from ``raw`` ``(B, 2)``; each model alone."""
    mu = torch.zeros_like(raw)
    nu = torch.zeros_like(raw)
    for count in range(1, n_steps + 1):
        _, g = objective.value_and_grad(raw)
        mu = (1.0 - b1) * g + b1 * mu
        nu = (1.0 - b2) * g * g + b2 * nu
        step = (mu / (1.0 - b1 ** count)) / (torch.sqrt(nu / (1.0 - b2 ** count)) + eps)
        raw = raw - learning_rate * step
    return raw


def bfgs(raw, n_steps, objective, learning_rate=None):
    """``n_steps`` of the damped per-model BFGS from ``raw`` ``(B, 2)``.

    A step takes the value and gradient at the iterate; updates the model's
    2 x 2 Hessian estimate B with the pair (s, y) of its last accepted step
    when s.y > 1e-8 |y|^2 and s.y > 1e-12; solves (B + lam I) d = -g;
    accepts the proposal where its value is finite and below the current
    one, halving lam, and else keeps the iterate and multiplies lam by 4
    (lam kept in [1e-8, 1e10]).  A model whose current value is not finite
    goes back to the start with B = I and lam = 1."""
    b = raw.shape[0]
    like = dict(dtype=raw.dtype, device=raw.device)
    eye = torch.eye(2, **like)
    hess = eye.expand(b, 2, 2).clone()
    lam = torch.ones((b,), **like)
    s_prev = torch.zeros((b, 2), **like)
    g_prev = torch.zeros((b, 2), **like)
    pending = torch.zeros((b,), dtype=torch.bool, device=raw.device)
    start = torch.full((b, 2), RAW_INIT, **like)
    for _ in range(n_steps):
        f, g = objective.value_and_grad(raw)
        dy = g - g_prev
        sy = torch.sum(s_prev * dy, dim=-1)
        ok = pending & (sy > 1e-8 * torch.sum(dy * dy, dim=-1)) & (sy > 1e-12)
        bs = torch.einsum("bij,bj->bi", hess, s_prev)
        sbs = torch.clamp(torch.sum(s_prev * bs, dim=-1), min=1e-30)
        updated = (hess - bs[:, :, None] * bs[:, None, :] / sbs[:, None, None]
                   + dy[:, :, None] * dy[:, None, :] / torch.clamp(sy, min=1e-30)[:, None, None])
        hess = torch.where(ok[:, None, None], updated, hess)
        damped = hess + lam[:, None, None] * eye
        det = damped[:, 0, 0] * damped[:, 1, 1] - damped[:, 0, 1] * damped[:, 1, 0]
        d = torch.stack([(-g[:, 0] * damped[:, 1, 1] + g[:, 1] * damped[:, 0, 1]) / det,
                         (g[:, 0] * damped[:, 1, 0] - g[:, 1] * damped[:, 0, 0]) / det], dim=-1)
        f_new = objective.value(raw + d)
        accept = torch.isfinite(f_new) & (f_new < f)
        stuck = ~torch.isfinite(f)
        raw = torch.where(stuck[:, None], start, torch.where(accept[:, None], raw + d, raw))
        hess = torch.where(stuck[:, None, None], eye, hess)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e10)
        lam = torch.where(stuck, torch.ones_like(lam), lam)
        accept = accept & ~stuck
        s_prev = torch.where(accept[:, None], d, torch.zeros_like(d))
        g_prev = g
        pending = accept
    return raw


OPTIMIZERS = {"adam": adam, "bfgs": bfgs}


class Objective:
    """The NLML of a batch of models at fixed data."""

    def __init__(self, dist, y, noise, jitter):
        self.dist, self.y, self.noise, self.jitter = dist, y, noise, jitter

    def value(self, raw):
        return nlml(raw, self.dist, self.y, self.noise, self.jitter)

    def value_and_grad(self, raw):
        return nlml_and_grad(raw, self.dist, self.y, self.noise, self.jitter)


def fit(dist, y, noise, profile, jitter):
    """Raw parameters ``(B, 2)`` after the profile's fit: ``n_optim_nits``
    steps of ``optimizer`` (on every ``time_stride``-th step when that is
    above 1, then ``fine_steps`` more at full T from there, with a fresh
    optimiser state)."""
    run = OPTIMIZERS[profile["optimizer"]]
    lr = profile.get("learning_rate", 0.01)
    raw = torch.full((y.shape[0], 2), RAW_INIT, dtype=y.dtype, device=y.device)
    stride = profile.get("time_stride", 1)
    if stride > 1:
        coarse = Objective(dist[:, ::stride, ::stride], y[:, ::stride], noise[:, ::stride], jitter)
        raw = run(raw, profile["n_optim_nits"], coarse, lr)
        return run(raw, profile["fine_steps"], Objective(dist, y, noise, jitter), lr)
    return run(raw, profile["n_optim_nits"], Objective(dist, y, noise, jitter), lr)


def marginals(raw, dist, y, noise, jitter):
    """Posterior marginal mean and variance ``(B, T)`` of the latent function
    at the training inputs."""
    t = y.shape[-1]
    k = _kernel(raw, dist)[0]
    l = _factor(_noisy(k, noise, jitter))
    z = torch.linalg.solve_triangular(l, y[:, :, None], upper=False)
    a = torch.linalg.solve_triangular(l.mT, z, upper=True)[..., 0]
    mean = torch.einsum("bij,bj->bi", k, a)
    eye = torch.eye(t, dtype=y.dtype, device=y.device).expand_as(l)
    wk = torch.matmul(torch.linalg.solve_triangular(l, eye, upper=False), k)
    var = torch.diagonal(k, dim1=-2, dim2=-1) - torch.sum(wk * wk, dim=-2)
    return mean, torch.clamp(var, min=1e-12)


def emulate(block, mask, profile, kernel, jitter, dba_fn, fit_block=4096):
    """DBA target, fit and posterior of ``B`` models ``(B, R, T)``: the
    marginal mean and the variance with the noise ``(B, T)`` each.  Models
    are independent, so the fit runs in blocks of ``fit_block``."""
    if kernel != "matern32":
        raise ValueError(f"the reference has the Matern-3/2 kernel only, not {kernel!r}")
    y = dba_fn(block, mask, profile["dba_iterations"])
    noise, x = targets_noise(block, mask)
    means, varis = [], []
    for lo in range(0, y.shape[0], fit_block):
        part = slice(lo, lo + fit_block)
        dist = distances(x[part])
        raw = fit(dist, y[part], noise[part], profile, jitter)
        mean, var = marginals(raw, dist, y[part], noise[part], jitter)
        means.append(mean)
        varis.append(var + noise[part])
    return torch.cat(means), torch.cat(varis)
