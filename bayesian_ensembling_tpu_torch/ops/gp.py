"""Batched exact Gaussian-process regression with known heteroskedastic noise.

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/gp.py``, main-path
subset: the softplus hyperparameters, the Matern-3/2 and RBF kernels with
the distance statistic hoisted out of the optimisation loop, the DBA
preamble, the batched Adam fit on the exact NLML, and the posterior
marginals.

    nlml = 0.5 y^T (K + D)^-1 y + 0.5 logdet(K + D) + T/2 log 2pi

Every batched function takes ``(M, ...)`` tensors, one row per model, and
runs on the device its inputs are on.
"""

from __future__ import annotations

import math
import typing as tp

import torch
from torch import nn

from bayesian_ensembling_tpu_torch._errors import not_ported
from bayesian_ensembling_tpu_torch.ops import dtw as dtw_ops
from bayesian_ensembling_tpu_torch.ops.linalg_cuda import chol_solve, nlml_terms, tri_inv

__all__ = [
    "BatchedGPParams",
    "softplus",
    "init_params",
    "get_kernel_precomputed",
    "prepare_gp_inputs",
    "fit_gp_batch",
    "fit_gp_batch_dispatch",
    "posterior_marginals_batch",
]

_LOG_2PI = 1.8378770664093453
_SQRT3 = 1.7320508075688772


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` computed as ``jax.nn.softplus`` does."""
    return torch.logaddexp(x, torch.zeros_like(x))


class BatchedGPParams(nn.Module):
    """Unconstrained kernel hyperparameters of ``M`` models, each ``(M,)``
    (softplus-transformed, matching GPflow's default positive bijector)."""

    def __init__(self, raw_lengthscale: torch.Tensor, raw_variance: torch.Tensor):
        super().__init__()
        if raw_lengthscale.shape != raw_variance.shape or raw_lengthscale.dim() != 1:
            raise ValueError(
                f"expected two (M,) tensors, got {raw_lengthscale.shape} and {raw_variance.shape}"
            )
        self.raw_lengthscale = nn.Parameter(raw_lengthscale)
        self.raw_variance = nn.Parameter(raw_variance)

    @property
    def lengthscale(self) -> torch.Tensor:
        return softplus(self.raw_lengthscale)

    @property
    def variance(self) -> torch.Tensor:
        return softplus(self.raw_variance)


def _softplus_inv(x: float) -> float:
    return float(math.log(math.expm1(x)))


def init_params(
    m: int,
    lengthscale: float = 1.0,
    variance: float = 1.0,
    *,
    device: torch.device | str,
    dtype: torch.dtype,
) -> BatchedGPParams:
    """``M`` models at the scratch initialisation (lengthscale = variance = 1)."""
    return BatchedGPParams(
        torch.full((m,), _softplus_inv(lengthscale), dtype=dtype, device=device),
        torch.full((m,), _softplus_inv(variance), dtype=dtype, device=device),
    )


def _sq_dists(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances between the rows of ``(M, N, D)`` and
    ``(M, P, D)``.  The product runs in full float32 on the card (TF32 is off
    by default); the TPU ran it at Precision.HIGHEST."""
    n1 = torch.sum(x1 * x1, dim=-1)
    n2 = torch.sum(x2 * x2, dim=-1)
    cross = torch.matmul(x1, x2.mT)
    d2 = n1[:, :, None] + n2[:, None, :] - 2.0 * cross
    return torch.clamp(d2, min=0.0)


def _matern32_from_dist(params: BatchedGPParams, dist: torch.Tensor) -> torch.Tensor:
    r = dist / params.lengthscale[:, None, None]
    return params.variance[:, None, None] * (1.0 + _SQRT3 * r) * torch.exp(-_SQRT3 * r)


def _rbf_from_sqdist(params: BatchedGPParams, d2: torch.Tensor) -> torch.Tensor:
    ls = params.lengthscale[:, None, None]
    return params.variance[:, None, None] * torch.exp(-0.5 * d2 / (ls * ls))


# (precompute(x1, x2) -> stat, apply(params, stat)): the distance statistic
# does not depend on the hyperparameters, so the optimisation loop hoists it.
_KERNELS_PRE: tp.Dict[str, tp.Tuple[tp.Callable, tp.Callable]] = {
    "matern32": (lambda x1, x2: torch.sqrt(_sq_dists(x1, x2) + 1e-36), _matern32_from_dist),
    "rbf": (_sq_dists, _rbf_from_sqdist),
}


def get_kernel_precomputed(name: str):
    try:
        return _KERNELS_PRE[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; options: {sorted(_KERNELS_PRE)}") from None


def prepare_gp_inputs(
    block: torch.Tensor,  # (M, R, T) zero-padded realisations
    mask: torch.Tensor,  # (M, R) validity
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
):
    """DBA target mean, known noise and feature matrix of each model.

    (a) masked classic-DBA barycentre -> target ``y_mean`` ``(M, T)``;
    (b) masked across-realisation variance, floored at 1e-8 -> ``y_var``;
    (c) the realisations time-major -> features ``x`` ``(M, T, R)``.
    """
    if dba_method == "subgradient":
        raise not_ported("dba_method='subgradient'", "A6")
    if dba_method != "classic":
        raise ValueError(f"dba_method must be 'classic' or 'subgradient', got {dba_method!r}")
    w = mask.to(block.dtype)
    n = torch.clamp(torch.sum(w, dim=1), min=1.0)
    y_mean = dtw_ops.dba_batch(block, mask, n_iterations=dba_iterations, init="mean", tol=dba_tol)
    mu_r = torch.einsum("mrt,mr->mt", block, w) / n[:, None]
    dev = block - mu_r[:, None, :]
    y_var = torch.einsum("mrt,mr->mt", dev * dev, w) / n[:, None]
    y_var = torch.clamp(y_var, min=1e-8)
    x = block.transpose(1, 2)
    return x, y_mean, y_var


class _Adam:
    """``optax.adam(lr)`` (b1=0.9, b2=0.999, eps=1e-8) on a list of tensors,
    written out so that each update follows optax's order of operations."""

    def __init__(self, params: tp.Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: tp.Sequence[torch.Tensor]) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(upd * -self.lr)


def fit_gp_batch(
    x: torch.Tensor,
    y: torch.Tensor,
    noise_var: torch.Tensor,
    kernel_name: str = "matern32",
    n_optim_nits: int = 500,
    learning_rate: float = 0.01,
    jitter: float = 1e-6,
    optimizer: str = "adam",
    init: tp.Optional[BatchedGPParams] = None,
) -> tp.Tuple[BatchedGPParams, torch.Tensor]:
    """Fit ``M`` independent GPs with Adam on the summed exact NLML.

    The models are independent, so the gradient of the sum is each model's
    own gradient.  Every step evaluates the NLML through the Cholesky-solve
    kernel and its gradient through the triangular-inverse kernel.

    Args:
      x: ``(M, T, D)`` feature matrices.  y: ``(M, T)`` DBA means.
      noise_var: ``(M, T)`` known noise.
      init: optional starting hyperparameters (e.g. from
        :func:`bayesian_ensembling_tpu_torch.convert.gp_params_from_jax`);
        they are copied, not modified.

    Returns:
      (fitted params, losses ``(M, n_optim_nits)``).
    """
    if optimizer != "adam":
        raise not_ported(f"optimizer={optimizer!r}", "A6")
    m, t, _ = x.shape
    precompute, apply_fn = get_kernel_precomputed(kernel_name)
    stat = precompute(x, x)
    diag_noise = torch.diag_embed(noise_var)
    jitter_eye = jitter * torch.eye(t, dtype=y.dtype, device=y.device)
    if init is None:
        params = init_params(m, device=y.device, dtype=y.dtype)
    else:
        params = BatchedGPParams(
            init.raw_lengthscale.detach().to(y.device, y.dtype, copy=True),
            init.raw_variance.detach().to(y.device, y.dtype, copy=True),
        )
    leaves = list(params.parameters())
    opt = _Adam(leaves, learning_rate)
    losses = torch.empty((n_optim_nits, m), dtype=y.dtype, device=y.device)
    for it in range(n_optim_nits):
        ky = apply_fn(params, stat) + diag_noise + jitter_eye
        quad, logdet = nlml_terms(ky, y)
        per_model = 0.5 * (quad + logdet + t * _LOG_2PI)
        grads = torch.autograd.grad(per_model.sum(), leaves)
        opt.step(grads)
        losses[it] = per_model.detach()
    return params, losses.T


def fit_gp_batch_dispatch(
    x: torch.Tensor,
    y: torch.Tensor,
    noise_var: torch.Tensor,
    kernel_name: str = "matern32",
    n_optim_nits: int = 500,
    learning_rate: float = 0.01,
    jitter: float = 1e-6,
    optimizer: str = "adam",
    init: tp.Optional[BatchedGPParams] = None,
    time_stride: int = 1,
    fine_steps: tp.Optional[int] = None,
    chunk_steps: tp.Optional[int] = None,
) -> tp.Tuple[BatchedGPParams, torch.Tensor]:
    """The scratch route of the JAX package's fit dispatch: one fit of
    ``n_optim_nits`` steps.  The coarse-to-fine and chunked routes raise."""
    if time_stride < 1:
        raise ValueError(f"time_stride must be >= 1, got {time_stride}")
    if time_stride > 1:
        raise not_ported("time_stride > 1 (coarse-to-fine in time)", "A6")
    if fine_steps is not None:
        raise ValueError(
            "fine_steps was given without time_stride > 1 — it only "
            "applies to the coarse-to-fine-in-time fit"
        )
    if chunk_steps is not None:
        raise not_ported("chunk_steps (host-chunked fit)", "A6")
    return fit_gp_batch(
        x, y, noise_var,
        kernel_name=kernel_name,
        n_optim_nits=n_optim_nits,
        learning_rate=learning_rate,
        jitter=jitter,
        optimizer=optimizer,
        init=init,
    )


@torch.no_grad()
def posterior_marginals_batch(
    params: BatchedGPParams,
    x: torch.Tensor,  # (M, T, D)
    y: torch.Tensor,  # (M, T)
    noise_var: torch.Tensor,  # (M, T)
    kernel_name: str = "matern32",
    jitter: float = 1e-6,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Posterior marginal mean and variance of the latent f at the training
    inputs: mean = K alpha and var_i = k_ii - ||(W K)_{:, i}||^2 with
    W = L^-1, through the Cholesky-solve and triangular-inverse kernels.
    Both products run in full float32 on the card (the TPU used HIGHEST)."""
    precompute, apply_fn = get_kernel_precomputed(kernel_name)
    k = apply_fn(params, precompute(x, x))
    t = k.shape[-1]
    ky = k + torch.diag_embed(noise_var) + jitter * torch.eye(t, dtype=k.dtype, device=k.device)
    l, _, alpha, _ = chol_solve(ky, y)
    mean = torch.einsum("bij,bj->bi", k, alpha)
    wk = torch.matmul(tri_inv(l), k)
    var = torch.diagonal(k, dim1=-2, dim2=-1) - torch.einsum("bji,bji->bi", wk, wk)
    return mean, torch.clamp(var, min=1e-12)
