"""Batched exact Gaussian-process regression with known heteroskedastic noise.

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/gp.py``: the softplus
hyperparameters, the Matern-3/2 and RBF kernels with the distance statistic
hoisted out of the optimisation loop, the DBA preamble (classic or
subgradient DBA), the batched fit on the exact NLML (Adam, the per-model
damped BFGS or optax's L-BFGS; merged, host-chunked or coarse-to-fine in
time), the posterior marginals and the full-covariance posterior, and the single-model API
(:func:`nlml`, :func:`posterior`, :func:`posterior_marginals`,
:func:`fit_gp`) on the JAX package's arguments: a :class:`GPParams` of one
model and a kernel callable.

    nlml = 0.5 y^T (K + D)^-1 y + 0.5 logdet(K + D) + T/2 log 2pi

Every batched function takes ``(M, ...)`` tensors, one row per model, and
runs on the device its inputs are on.  The single-model functions take
unbatched ``x (T, D)``, ``y (T,)``, ``noise_var (T,)``, a :class:`GPParams`
(or a :class:`BatchedGPParams` of one model) and ``kernel``: a callable
``(params, x1, x2) -> K`` such as :func:`matern32` / :func:`rbf`, or a
kernel's name; ``kernel_name=`` names it too.
"""

from __future__ import annotations

import functools
import math
import threading
import types
import typing as tp
import warnings

import torch
from torch import nn

from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops import dtw as dtw_ops
from bayesian_ensembling_tpu_torch.ops import gram as gram_ops
from bayesian_ensembling_tpu_torch.ops import lbfgs as lbfgs_ops
from bayesian_ensembling_tpu_torch.ops import linalg_cuda
from bayesian_ensembling_tpu_torch.ops.linalg_blocked import nlml_route
from bayesian_ensembling_tpu_torch.utils.profiling import span

__all__ = [
    "BatchedGPParams",
    "GPParams",
    "softplus",
    "init_params",
    "matern32",
    "rbf",
    "get_kernel",
    "get_kernel_precomputed",
    "nlml",
    "posterior",
    "posterior_marginals",
    "fit_gp",
    "posterior_batch",
    "prepare_gp_inputs",
    "fit_gp_batch",
    "fit_gp_batch_segment",
    "fit_gp_batch_chunked",
    "fit_gp_batch_warm_time",
    "fit_gp_batch_dispatch",
    "posterior_marginals_batch",
]

_LOG_2PI = 1.8378770664093453

# Optimiser steps of the batched fit since the last reset (the package's
# ``reset_launch_counts``), by optimiser: ``fit_gp_batch_segment`` adds each
# segment's ``n_steps`` once, and nothing else adds to it.
FIT_STEPS = {"adam": 0, "bfgs": 0, "lbfgs": 0}
# Of those, the steps that ran as replays of a captured CUDA graph (the
# package's ``fit_replay_counts``): ``fit_gp_batch_segment``'s Adam loop on a
# card adds each segment's replays once.
FIT_REPLAYS = {"adam": 0}

# Eager Adam steps that open a segment on a card, on the stream its capture
# then uses: they set up that stream's cuBLAS workspace and the autograd
# engine's device thread before the capture.  A segment of no more steps
# runs eagerly throughout.
GRAPH_WARMUP_STEPS = 3
# Per card: the stream of a segment's eager steps and capture, and the last
# segment's graph.  Each capture shares that graph's memory pool, so every
# segment reuses one step's intermediates; the old graph is freed once the
# new capture holds the pool (PyTorch cannot hand a pool that no live graph
# holds to a new capture).  One graphed segment runs at a time, so two
# threads never share a capture stream.
_capture_resources: tp.Dict[torch.device,
                         tp.Tuple["torch.cuda.Stream", "torch.cuda.CUDAGraph"]] = {}
_capture_lock = threading.Lock()


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` by ``torch.logaddexp``, which can round an ulp
    away from ``jax.nn.softplus``.  ``ops/svgp.py`` keeps JAX's rounding
    (ROADMAP C12); here it would move ``MeanField``'s fit, whose Adam starts
    at the closed-form optimum where the gradient is round-off, from within
    1e-3 of the JAX package to 4.1e-3
    (``tests/test_torch_library_api.py::test_mean_field_refinement_matches_jax``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class BatchedGPParams(nn.Module):
    """Unconstrained kernel hyperparameters of ``M`` models, each ``(M,)``
    (softplus-transformed, matching GPflow's default positive bijector).

    The gridded surface (``parallel/gridded.py``) holds ``(M, C)`` leaves,
    one value per model and cell, as the JAX ``GPParams`` does there; the
    batched fits take ``(M,)`` leaves."""

    def __init__(self, raw_lengthscale: torch.Tensor, raw_variance: torch.Tensor):
        super().__init__()
        if raw_lengthscale.shape != raw_variance.shape or raw_lengthscale.dim() not in (1, 2):
            raise ValueError(
                "expected two (M,) or two (M, C) tensors, got "
                f"{raw_lengthscale.shape} and {raw_variance.shape}"
            )
        self.raw_lengthscale = nn.Parameter(raw_lengthscale)
        self.raw_variance = nn.Parameter(raw_variance)

    @property
    def lengthscale(self) -> torch.Tensor:
        return softplus(self.raw_lengthscale)

    @property
    def variance(self) -> torch.Tensor:
        return softplus(self.raw_variance)


class GPParams(nn.Module):
    """Unconstrained kernel hyperparameters of ONE model, each a 0-d tensor
    (the JAX package's ``GPParams``): what :func:`fit_gp` returns and
    :func:`nlml`, :func:`posterior` and :func:`posterior_marginals` take."""

    def __init__(self, raw_lengthscale, raw_variance):
        super().__init__()
        raw_lengthscale, raw_variance = torch.as_tensor(raw_lengthscale), torch.as_tensor(raw_variance)
        if raw_lengthscale.dim() or raw_variance.dim():
            raise ValueError(
                "expected two 0-d tensors (one model), got shapes "
                f"{tuple(raw_lengthscale.shape)} and {tuple(raw_variance.shape)}; "
                "use BatchedGPParams for a batch"
            )
        self.raw_lengthscale = nn.Parameter(raw_lengthscale)
        self.raw_variance = nn.Parameter(raw_variance)

    @property
    def lengthscale(self) -> torch.Tensor:
        return softplus(self.raw_lengthscale)

    @property
    def variance(self) -> torch.Tensor:
        return softplus(self.raw_variance)


def _as_batch(params):
    """``params`` as a batch of models: a :class:`GPParams` becomes a view
    with ``(1,)`` ``lengthscale`` / ``variance`` (differentiable in the
    leaves); a :class:`BatchedGPParams` is returned as it is."""
    if isinstance(params, GPParams):
        return types.SimpleNamespace(lengthscale=params.lengthscale.reshape(1),
                                     variance=params.variance.reshape(1))
    return params


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
    return gram_ops.matern32_from_dist(params.lengthscale, params.variance, dist)


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


def _batched_kernel(name: str):
    precompute, apply_fn = _KERNELS_PRE[name]

    def kernel(params, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        params = _as_batch(params)
        if x1.dim() == 2:  # one model: (N, D) and (P, D)
            return apply_fn(params, precompute(x1[None], x2[None]))[0]
        return apply_fn(params, precompute(x1, x2))

    kernel.__name__ = name
    return kernel


#: Matern-3/2 kernel, the reference's emulator kernel: ``(M, N, D)`` and
#: ``(M, P, D)`` inputs give ``(M, N, P)``; unbatched inputs one matrix
#: (with a :class:`GPParams`, or a :class:`BatchedGPParams` of one model).
matern32 = _batched_kernel("matern32")
#: Squared-exponential kernel, same shapes.
rbf = _batched_kernel("rbf")
_KERNELS = {"matern32": matern32, "rbf": rbf}


def get_kernel(name: str):
    try:
        return _KERNELS[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; options: {sorted(_KERNELS)}") from None


def _single_kernel(kernel, kernel_name: tp.Optional[str]):
    """The kernel callable of the single-model API: ``kernel`` (a callable
    or a name), or the kernel named ``kernel_name``."""
    if kernel_name is not None:
        if kernel is not matern32:
            raise TypeError("pass the kernel as kernel= or as kernel_name=, not both")
        return get_kernel(kernel_name)
    if isinstance(kernel, str):
        return get_kernel(kernel)
    if not callable(kernel):
        raise TypeError(f"kernel must be a callable (params, x1, x2) -> K or a name, got {kernel!r}")
    return kernel


def prepare_gp_inputs(
    block: torch.Tensor,  # (M, R, T) zero-padded realisations
    mask: torch.Tensor,  # (M, R) validity
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
):
    """DBA target mean, known noise and feature matrix of each model.

    (a) masked DBA barycentre -> target ``y_mean`` ``(M, T)``;
    (b) masked across-realisation variance, floored at 1e-8 -> ``y_var``;
    (c) the realisations time-major -> features ``x`` ``(M, T, R)``.

    ``dba_method="classic"`` runs ``dba_iterations`` classic DBA updates
    from the mean (``dba_tol`` makes the count a cap with movement-based
    stopping); ``"subgradient"`` runs the stochastic subgradient DBA the
    reference flagship calls, with ``max_iter=dba_iterations`` epochs (the
    reference passes 50) and ``tol=dba_tol`` (1e-3 when omitted).
    """
    with span("dba", block, B=block.shape[0], T=block.shape[-1], method=dba_method,
              iterations=dba_iterations):
        if dba_method == "classic":
            y_mean = dtw_ops.dba_batch(block, mask, n_iterations=dba_iterations, init="mean",
                                       tol=dba_tol)
        elif dba_method == "subgradient":
            y_mean = dtw_ops.dba_subgradient_batch(
                block, mask, max_iter=dba_iterations, tol=1e-3 if dba_tol is None else dba_tol
            )
        else:
            raise ValueError(f"dba_method must be 'classic' or 'subgradient', got {dba_method!r}")
        w = mask.to(block.dtype)
        n = torch.clamp(torch.sum(w, dim=1), min=1.0)
        mu_r = torch.einsum("mrt,mr->mt", block, w) / n[:, None]
        dev = block - mu_r[:, None, :]
        y_var = torch.einsum("mrt,mr->mt", dev * dev, w) / n[:, None]
        y_var = torch.clamp(y_var, min=1e-8)
        x = block.transpose(1, 2)
    return x, y_mean, y_var


class _Adam:
    """``optax.adam(lr)`` (b1=0.9, b2=0.999, eps=1e-8) state for a list of
    tensors, written out so that each update follows optax's order of
    operations."""

    def __init__(self, params: tp.Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params: tp.Sequence[torch.Tensor], grads: tp.Sequence[torch.Tensor]) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(upd * -self.lr)


class _BatchBFGS:
    """State of the per-model damped quasi-Newton optimiser
    (``optimizer="bfgs"``; the step lives in :func:`_build_batch_step`).

    Each model owns its 2x2 BFGS Hessian approximation, a Levenberg-style
    damping scalar and the delayed curvature pair of its last accepted step;
    nothing couples the batch."""

    def __init__(self, params: BatchedGPParams):
        m = params.raw_lengthscale.shape[0]
        like = dict(dtype=params.raw_lengthscale.dtype, device=params.raw_lengthscale.device)
        self.hess = torch.eye(2, **like).expand(m, 2, 2).clone()  # B ~ Hessian
        self.lam = torch.ones((m,), **like)  # damping
        self.s_pend = torch.zeros((m, 2), **like)  # pending accepted step s
        self.g_prev = torch.zeros((m, 2), **like)  # gradient at the previous iterate
        self.pend_ok = torch.zeros((m,), dtype=torch.bool, device=like["device"])


class _LBFGS:
    """State of ``optimizer="lbfgs"``: ``optax.lbfgs()``'s, as
    :class:`~bayesian_ensembling_tpu_torch.ops.lbfgs.LBFGSState` over the
    leaves ``(raw_lengthscale, raw_variance)`` stacked ``(2, M)``.  One line
    search, so one step size, serves the batch's summed objective."""

    def __init__(self, params: BatchedGPParams):
        self.state = lbfgs_ops.init(_stack_leaves(params))


def _stack_leaves(params) -> torch.Tensor:
    return torch.stack([params.raw_lengthscale.detach(), params.raw_variance.detach()])


def _make_batch_opt(optimizer: str, learning_rate: float, params: BatchedGPParams):
    """The optimiser state of every batched-fit entry point (one place, so
    the merged fit and the host-chunked segments cannot drift)."""
    if optimizer == "adam":
        return _Adam(list(params.parameters()), learning_rate)
    if optimizer == "bfgs":
        return _BatchBFGS(params)
    if optimizer == "lbfgs":
        return _LBFGS(params)
    raise ValueError(f"unknown optimizer {optimizer!r}")


def _build_batch_step(x, y, noise_var, kernel_name, jitter, optimizer, route=None):
    """The per-iteration step of the batched NLML optimisation,
    ``step(params, opt) -> per-model NLML (M,)`` at the iterate, updating
    ``params`` and the optimiser state ``opt`` in place.

    Shared by :func:`fit_gp_batch` and :func:`fit_gp_batch_segment`, so a
    fit split into segments runs the exact same step sequence as the merged
    one.  ``route``, ``linalg_cuda.linalg_path(T, b=M, dtype)`` unless the
    caller has it, picks the NLML once, as the JAX package does: the
    recursive blocked NLML on the blocked route, else
    ``linalg_cuda.nlml_terms``.  On a card the Matern-3/2 NLML runs on the
    Gram kernels (``ops/gram.matern32_nlml_terms``: the Gram and the
    contraction of its gradient as two launches); elsewhere, and for
    ``"rbf"``, autograd runs the kernel's elementwise chain.
    """
    m, t, _ = x.shape
    precompute, apply_fn = get_kernel_precomputed(kernel_name)
    stat = precompute(x, x)  # hyperparameter-independent: hoisted out of the loop
    if route is None:
        route = linalg_cuda.linalg_path(t, b=m, dtype=y.dtype)
    if kernel_name == "matern32" and y.device.type == "cuda":
        noise_var = noise_var.contiguous()

        def nlml_terms(params):
            return gram_ops.matern32_nlml_terms(stat, params.lengthscale, params.variance,
                                                noise_var, y, jitter, route)
    else:
        diag_noise = torch.diag_embed(noise_var)
        jitter_eye = jitter * torch.eye(t, dtype=y.dtype, device=y.device)
        forward, kinv = nlml_route(route)

        def nlml_terms(params):
            return linalg_cuda.nlml_terms_on(apply_fn(params, stat) + diag_noise + jitter_eye, y,
                                             forward, kinv)

    def nlml_vec(params):
        quad, logdet = nlml_terms(params)
        return 0.5 * (quad + logdet + t * _LOG_2PI)

    def value_and_grad(params):
        leaves = [params.raw_lengthscale, params.raw_variance]
        per_model = nlml_vec(params)
        return per_model.detach(), torch.autograd.grad(per_model.sum(), leaves)

    if optimizer == "adam":

        def step(params, opt):
            per_model, grads = value_and_grad(params)
            opt.step([params.raw_lengthscale, params.raw_variance], grads)
            return per_model

        step.value_and_grad = value_and_grad  # what _adam_graphed captures
        return step

    if optimizer == "lbfgs":

        def summed_value_and_grad(z):
            # optax's value_and_grad of the summed objective at the stacked
            # leaves z (2, M).
            with torch.enable_grad():
                z = z.detach().requires_grad_(True)
                total = nlml_vec(types.SimpleNamespace(
                    lengthscale=softplus(z[0]), variance=softplus(z[1]))).sum()
                (grad,) = torch.autograd.grad(total, z)
            return total.detach(), grad

        def step(params, opt):
            # optax.lbfgs's update at the iterate, then the loss the JAX
            # package records: every model's NLML after the update (one
            # more forward, no gradient).
            z, opt.state = lbfgs_ops.update(summed_value_and_grad, _stack_leaves(params),
                                            opt.state)
            with torch.no_grad():
                params.raw_lengthscale.copy_(z[0])
                params.raw_variance.copy_(z[1])
                return nlml_vec(params)

        return step

    if optimizer != "bfgs":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    init_v = torch.tensor([_softplus_inv(1.0)] * 2, dtype=y.dtype, device=y.device)
    eye2 = torch.eye(2, dtype=y.dtype, device=y.device)

    def step(params, opt):
        # One value and gradient at the iterate and one value-only proposal
        # per step; each model solves its own damped 2x2 system and accepts
        # or rejects on its own.  The BFGS update is delayed one step: the
        # pair (s, y) needs the gradient at the accepted proposal, which is
        # this step's gradient.
        per_model, grads = value_and_grad(params)
        with torch.no_grad():
            g = torch.stack(grads, dim=-1)
            yv = g - opt.g_prev
            sy = torch.sum(opt.s_pend * yv, dim=-1)
            # Scale-relative curvature test: s^T y > 1e-8 |y|^2 bounds the
            # rank-one term |y|^2 / s^T y at 1e8, which damping dominates.
            y_sq = torch.sum(yv * yv, dim=-1)
            ok = opt.pend_ok & (sy > 1e-8 * y_sq) & (sy > 1e-12)
            bs = torch.einsum("mij,mj->mi", opt.hess, opt.s_pend)
            sbs = torch.clamp(torch.sum(opt.s_pend * bs, dim=-1), min=1e-30)
            upd = (
                opt.hess
                - bs[:, :, None] * bs[:, None, :] / sbs[:, None, None]
                + yv[:, :, None] * yv[:, None, :] / torch.clamp(sy, min=1e-30)[:, None, None]
            )
            hess = torch.where(ok[:, None, None], upd, opt.hess)
            # Damped closed-form 2x2 solve: (B + lambda I) delta = -g.
            a = hess[:, 0, 0] + opt.lam
            b = hess[:, 0, 1]
            c = hess[:, 1, 0]
            d = hess[:, 1, 1] + opt.lam
            det = a * d - b * c
            delta = torch.stack(
                [(-g[:, 0] * d + g[:, 1] * b) / det, (g[:, 0] * c - g[:, 1] * a) / det], dim=-1
            )
            v = torch.stack([params.raw_lengthscale, params.raw_variance], dim=-1)
            prop = v + delta
            f_prop = nlml_vec(types.SimpleNamespace(
                lengthscale=softplus(prop[:, 0]), variance=softplus(prop[:, 1])))
            accept = torch.isfinite(f_prop) & (f_prop < per_model)
            new_v = torch.where(accept[:, None], prop, v)
            # NaN rescue: a model whose current objective is non-finite can
            # never improve (every comparison with NaN is False); reset it to
            # the scratch init with a fresh optimiser state.
            stuck = ~torch.isfinite(per_model)
            new_v = torch.where(stuck[:, None], init_v[None, :], new_v)
            params.raw_lengthscale.copy_(new_v[:, 0])
            params.raw_variance.copy_(new_v[:, 1])
            opt.hess = torch.where(stuck[:, None, None], eye2[None], hess)
            lam = torch.clamp(torch.where(accept, opt.lam * 0.5, opt.lam * 4.0), 1e-8, 1e10)
            opt.lam = torch.where(stuck, 1.0, lam)
            accept = accept & ~stuck
            opt.s_pend = torch.where(accept[:, None], delta, 0.0)
            opt.g_prev = g
            opt.pend_ok = accept
        return per_model

    return step


def _start_params(m: int, y: torch.Tensor, init: tp.Optional[BatchedGPParams]) -> BatchedGPParams:
    """The scratch initialisation, or a copy of ``init`` on ``y``'s device
    and dtype (the caller's parameters are never modified)."""
    if init is None:
        return init_params(m, device=y.device, dtype=y.dtype)
    return BatchedGPParams(
        init.raw_lengthscale.detach().to(y.device, y.dtype, copy=True),
        init.raw_variance.detach().to(y.device, y.dtype, copy=True),
    )


def _warn_non_finite(losses: torch.Tensor, t: int, optimizer: str) -> None:
    """Warn, naming them, about the models whose NLML went non-finite (a
    Gram that is not positive definite in the working precision)."""
    bad = torch.nonzero(~torch.isfinite(losses).all(dim=1)).flatten().tolist()
    if bad:
        fate = {
            "bfgs": "bfgs reset them to the scratch initialisation",
            # One line search steps the summed objective: a trial point
            # where it is non-finite only shortens the step, but a
            # non-finite iterate makes the direction non-finite and
            # optax's safe step of size 0 turns every model's
            # hyperparameters NaN.
            "lbfgs": ("lbfgs sums the batch into one objective, so a non-finite model at the "
                      "iterate turns every model's hyperparameters NaN; refit without it"),
        }.get(optimizer, "their fitted hyperparameters are not usable")
        warnings.warn(
            f"fit_gp_batch: the NLML of model(s) {bad} of {losses.shape[0]} went non-finite at "
            f"T={t} ({losses.dtype}); {fate}",
            stacklevel=3,
        )


def _free_cublas_workspaces() -> None:
    """Hand the cuBLAS workspaces back to PyTorch's caching allocator.

    PyTorch holds one workspace (32 MiB on an H100) per (cuBLAS handle,
    stream), allocated at the first GEMM on a stream and kept.  A graphed
    segment frees the caller's stream's before its capture stream takes
    one, and that one when it ends, so the two are never held at once."""
    torch._C._cuda_clearCublasWorkspaces()


def _adam_graphed(step, params: BatchedGPParams, opt: _Adam, losses: torch.Tensor) -> None:
    """``losses.shape[0]`` Adam steps of ``step`` on the card, the NLML of
    step k into row k of ``losses``: :data:`GRAPH_WARMUP_STEPS` eager steps
    on the capture stream, then the step captured once as a CUDA graph and
    replayed, on the caller's stream, for each of the rest.

    The graph is ``step`` with ``_Adam.step``'s update written out in its
    order of operations, except for the bias corrections: the eager step
    divides by Python floats, which CUDA does as a product with their
    reciprocal, taken in float64 and rounded to the tensors' dtype, so the
    graph multiplies by the same reciprocals, read from a table at a step
    counter on the card, which also picks the row of ``losses``.  The
    kernel launch and route counters gain the captured step's counts once
    a replay."""
    n, device = losses.shape[0], losses.device
    side, last = _capture_resources.get(device) or (torch.cuda.Stream(device), None)
    main = torch.cuda.current_stream(device)
    inv = torch.tensor([[1.0 / (1.0 - opt.b1 ** k), 1.0 / (1.0 - opt.b2 ** k)]
                        for k in range(opt.count + 1, opt.count + n + 1)], dtype=torch.float64)
    inv = inv.to(losses.dtype).pin_memory().to(device, non_blocking=True)
    it = torch.full((1,), GRAPH_WARMUP_STEPS, dtype=torch.int64, device=device)
    leaves = [params.raw_lengthscale, params.raw_variance]
    counters = (_build.LAUNCHES, _build.ROUTES)
    _free_cublas_workspaces()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for k in range(GRAPH_WARMUP_STEPS):
            losses[k] = step(params, opt)
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=None if last is None else last.pool())
        try:
            per_model, grads = step.value_and_grad(params)
            with torch.no_grad():
                inv_c1, inv_c2 = inv.index_select(0, it).unbind(1)
                for p, g, mu, nu in zip(leaves, grads, opt.mu, opt.nu):
                    mu.copy_((1.0 - opt.b1) * g + opt.b1 * mu)
                    nu.copy_((1.0 - opt.b2) * (g * g) + opt.b2 * nu)
                    upd = (mu * inv_c1) / (torch.sqrt(nu * inv_c2) + opt.eps)
                    p.add_(upd * -opt.lr)
                losses.index_copy_(0, it, per_model[None])
                it.add_(1)
        finally:  # a failed capture must not leave the stream capturing
            graph.capture_end()
    if last is not None:
        last.reset()
    _capture_resources[device] = (side, graph)
    replays = n - GRAPH_WARMUP_STEPS
    main.wait_stream(side)
    for _ in range(replays):
        graph.replay()
    for counter, was in zip(counters, before):
        for name in counter:  # the capture counted one step's launches
            counter[name] += (counter[name] - was[name]) * (replays - 1)
    opt.count += replays
    # The capture stream's cached blocks and workspace, and the pool's blocks,
    # go to later work, which must follow the replays.
    side.wait_stream(main)
    _free_cublas_workspaces()


def fit_gp_batch_segment(
    x: torch.Tensor,
    y: torch.Tensor,
    noise_var: torch.Tensor,
    params: BatchedGPParams,
    opt_state,
    kernel_name: str = "matern32",
    n_steps: int = 250,
    jitter: float = 1e-6,
    optimizer: str = "adam",
):
    """One ``n_steps``-long segment of the batched fit, carrying the
    optimiser state: the building block of :func:`fit_gp_batch` and
    :func:`fit_gp_batch_chunked`.  ``params`` and ``opt_state`` (from
    ``_make_batch_opt``, which holds the learning rate) are updated in
    place.

    Adam on a card runs the segment past its first
    :data:`GRAPH_WARMUP_STEPS` steps as replays of one CUDA graph of the
    step (``_adam_graphed``), bit for bit the eager loop; on the CPU, and
    for the other optimisers, each step is a Python call.

    The ``fit.loop`` span carries the segment's linear-algebra ``route``
    (``linalg_cuda.linalg_path``: ``kernel``, ``blocked`` or ``library``),
    the one its step takes.

    Returns ``(params, opt_state, losses (M, n_steps))``.
    """
    route = linalg_cuda.linalg_path(y.shape[-1], b=x.shape[0], dtype=y.dtype)
    step = _build_batch_step(x, y, noise_var, kernel_name, jitter, optimizer, route)
    losses = torch.empty((n_steps, x.shape[0]), dtype=y.dtype, device=y.device)
    graphed = optimizer == "adam" and y.is_cuda and n_steps > GRAPH_WARMUP_STEPS
    replays = n_steps - GRAPH_WARMUP_STEPS if graphed else 0
    with span("fit.loop", y, B=y.shape[0], T=y.shape[-1], optimizer=optimizer, steps=n_steps,
              replays=replays, route=route):
        if graphed:
            with _capture_lock:
                _adam_graphed(step, params, opt_state, losses)
        else:
            for it in range(n_steps):
                losses[it] = step(params, opt_state)
    FIT_STEPS[optimizer] += n_steps
    FIT_REPLAYS["adam"] += replays
    return params, opt_state, losses.T


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
    """Fit ``M`` independent GPs on the summed exact NLML.

    The models are independent, so the gradient of the sum is each model's
    own gradient.  ``optimizer="adam"`` (the reference's), ``"bfgs"``
    (per-model damped quasi-Newton in the two raw hyperparameters, which
    converges in about 30 steps) or ``"lbfgs"`` (``optax.lbfgs()``,
    :mod:`~bayesian_ensembling_tpu_torch.ops.lbfgs`: one zoom line search,
    so one step size, for the summed objective; the recorded loss is each
    model's NLML after the step).  A model whose loss goes non-finite draws
    a warning naming it; the fit itself goes on, as in the JAX package.

    Args:
      x: ``(M, T, D)`` feature matrices.  y: ``(M, T)`` DBA means.
      noise_var: ``(M, T)`` known noise.
      init: optional starting hyperparameters (e.g. from
        :func:`bayesian_ensembling_tpu_torch.convert.gp_params_from_jax`);
        they are copied, not modified.

    Returns:
      (fitted params, losses ``(M, n_optim_nits)``).
    """
    params = _start_params(x.shape[0], y, init)
    opt = _make_batch_opt(optimizer, learning_rate, params)
    params, _, losses = fit_gp_batch_segment(
        x, y, noise_var, params, opt, kernel_name=kernel_name, n_steps=n_optim_nits,
        jitter=jitter, optimizer=optimizer,
    )
    _warn_non_finite(losses, x.shape[1], optimizer)
    return params, losses


def fit_gp_batch_chunked(
    x: torch.Tensor,
    y: torch.Tensor,
    noise_var: torch.Tensor,
    kernel_name: str = "matern32",
    n_optim_nits: int = 500,
    learning_rate: float = 0.01,
    jitter: float = 1e-6,
    optimizer: str = "adam",
    init: tp.Optional[BatchedGPParams] = None,
    chunk_steps: int = 250,
) -> tp.Tuple[BatchedGPParams, torch.Tensor]:
    """:func:`fit_gp_batch` as a host loop of segments of ``chunk_steps``
    steps, each ended by a device synchronisation.

    The optimiser state carries across segments, so the result equals the
    merged fit's bit for bit; each segment bounds one uninterrupted stretch
    of device work.
    """
    if chunk_steps <= 0:
        raise ValueError(
            f"chunk_steps must be positive, got {chunk_steps} (the host loop would never advance)"
        )
    params = _start_params(x.shape[0], y, init)
    opt = _make_batch_opt(optimizer, learning_rate, params)
    losses = []
    done = 0
    while done < n_optim_nits:
        k = min(chunk_steps, n_optim_nits - done)
        params, opt, seg = fit_gp_batch_segment(
            x, y, noise_var, params, opt, kernel_name=kernel_name, n_steps=k,
            jitter=jitter, optimizer=optimizer,
        )
        if seg.is_cuda:
            torch.cuda.synchronize(seg.device)  # bound each stretch of device work
        losses.append(seg)
        done += k
    losses = torch.cat(losses, dim=1) if losses else y.new_empty((x.shape[0], 0))
    _warn_non_finite(losses, x.shape[1], optimizer)
    return params, losses


def fit_gp_batch_warm_time(
    x: torch.Tensor,
    y: torch.Tensor,
    noise_var: torch.Tensor,
    kernel_name: str = "matern32",
    time_stride: int = 12,
    coarse_steps: int = 500,
    fine_steps: int = 100,
    learning_rate: float = 0.01,
    jitter: float = 1e-6,
    optimizer: str = "adam",
    init: tp.Optional[BatchedGPParams] = None,
    chunk_steps: tp.Optional[int] = None,
) -> tp.Tuple[BatchedGPParams, torch.Tensor]:
    """Coarse-to-fine in time: ``coarse_steps`` steps on every
    ``time_stride``-th timestep (``init`` seeds them), then ``fine_steps``
    steps at full T warm-started from the coarse optimum (host-chunked when
    ``chunk_steps`` is given; the coarse pass is always merged).

    Returns ``(params, losses (M, coarse_steps + fine_steps))``; the two
    loss segments are NLMLs of series of different length.
    """
    if time_stride < 1:
        raise ValueError(f"time_stride must be >= 1, got {time_stride}")
    if fine_steps <= 0:
        raise ValueError(f"fine_steps must be positive, got {fine_steps}")
    kw = dict(kernel_name=kernel_name, learning_rate=learning_rate, jitter=jitter,
              optimizer=optimizer)
    fit = (functools.partial(fit_gp_batch_chunked, chunk_steps=chunk_steps)
           if chunk_steps is not None else fit_gp_batch)
    if time_stride == 1:
        # Degenerate stride: coarse == fine resolution, run the total.
        return fit(x, y, noise_var, n_optim_nits=coarse_steps + fine_steps, init=init, **kw)
    coarse_params, coarse_losses = fit_gp_batch(
        x[:, ::time_stride, :].contiguous(),
        y[:, ::time_stride].contiguous(),
        noise_var[:, ::time_stride].contiguous(),
        n_optim_nits=coarse_steps, init=init, **kw,
    )
    params, fine_losses = fit(x, y, noise_var, n_optim_nits=fine_steps, init=coarse_params, **kw)
    return params, torch.cat([coarse_losses, fine_losses], dim=1)


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
    """The one owner of the scratch / coarse-to-fine / chunked fit routing:

    - ``time_stride == 1``: a scratch fit of ``n_optim_nits`` steps
      (``fine_steps`` must be None), merged, or host-chunked when
      ``chunk_steps`` is given;
    - ``time_stride > 1``: :func:`fit_gp_batch_warm_time` with
      ``n_optim_nits`` coarse steps and ``fine_steps`` (required) fine ones;
    - ``time_stride < 1`` raises.
    """
    if time_stride < 1:
        raise ValueError(f"time_stride must be >= 1, got {time_stride}")
    if time_stride > 1 and fine_steps is None:
        raise ValueError(
            "time_stride > 1 requires fine_steps (the number of "
            "full-resolution warm-started optimisation steps)"
        )
    if time_stride == 1 and fine_steps is not None:
        raise ValueError(
            "fine_steps was given without time_stride > 1 — it only "
            "applies to the coarse-to-fine-in-time fit"
        )
    kw = dict(kernel_name=kernel_name, learning_rate=learning_rate, jitter=jitter,
              optimizer=optimizer, init=init)
    with span("fit", y, B=y.shape[0], T=y.shape[-1], optimizer=optimizer,
              steps=n_optim_nits + (fine_steps or 0)):
        if time_stride > 1:
            return fit_gp_batch_warm_time(
                x, y, noise_var, time_stride=time_stride, coarse_steps=n_optim_nits,
                fine_steps=fine_steps, chunk_steps=chunk_steps, **kw,
            )
        if chunk_steps is not None:
            return fit_gp_batch_chunked(
                x, y, noise_var, n_optim_nits=n_optim_nits, chunk_steps=chunk_steps, **kw
            )
        return fit_gp_batch(x, y, noise_var, n_optim_nits=n_optim_nits, **kw)


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
    W = L^-1.  The Cholesky-solve and triangular-inverse kernels within
    their size cap, torch.linalg beyond (``linalg_cuda``'s routed calls; no
    blocked route), as the JAX posterior takes XLA's.  Both products run in
    full float32 on the card (the TPU used HIGHEST)."""
    precompute, apply_fn = get_kernel_precomputed(kernel_name)
    with span("posterior", y, B=y.shape[0], T=y.shape[-1]):
        return _marginals_from_gram(apply_fn(params, precompute(x, x)), y, noise_var, jitter)


def _noisy_factor(k, y, noise_var, jitter):
    """``L`` of ``K + diag(noise) + jitter I`` and ``alpha = (K + ...)^-1 y``,
    batched: the Cholesky-solve kernel within its size cap."""
    t = k.shape[-1]
    ky = k + torch.diag_embed(noise_var) + jitter * torch.eye(t, dtype=k.dtype, device=k.device)
    l, _, alpha, _ = linalg_cuda.chol_solve_routed(ky, y)
    return l, alpha


def _marginals_from_gram(k, y, noise_var, jitter):
    l, alpha = _noisy_factor(k, y, noise_var, jitter)
    mean = torch.einsum("bij,bj->bi", k, alpha)
    wk = torch.matmul(linalg_cuda.tri_inv_routed(l), k)
    var = torch.diagonal(k, dim1=-2, dim2=-1) - torch.einsum("bji,bji->bi", wk, wk)
    return mean, torch.clamp(var, min=1e-12)


def _posterior_from_gram(k, y, noise_var, jitter):
    l, alpha = _noisy_factor(k, y, noise_var, jitter)
    mean = torch.einsum("bij,bj->bi", k, alpha)
    v = torch.linalg.solve_triangular(l, k, upper=False)
    return mean, k - torch.matmul(v.mT, v)


@torch.no_grad()
def posterior_batch(
    params: BatchedGPParams,
    x: torch.Tensor,  # (M, T, D)
    y: torch.Tensor,  # (M, T)
    noise_var: torch.Tensor,  # (M, T)
    kernel_name: str = "matern32",
    jitter: float = 1e-6,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Exact posterior mean ``(M, T)`` and full covariance ``(M, T, T)`` of
    the latent f at the training inputs: ``mean = K alpha`` and
    ``cov = K - V^T V`` with ``V = L^-1 K``.

    The factor and alpha come from the Cholesky-solve kernel within its size
    cap (torch.linalg beyond); ``V`` is a triangular solve with a matrix
    right-hand side, left to ``torch.linalg`` as the JAX package leaves it
    to XLA.  Both products run in full float32 on the card."""
    precompute, apply_fn = get_kernel_precomputed(kernel_name)
    return _posterior_from_gram(apply_fn(params, precompute(x, x)), y, noise_var, jitter)


def _one_model(params) -> None:
    if isinstance(params, BatchedGPParams) and params.raw_lengthscale.shape[0] != 1:
        raise ValueError(
            "the single-model API takes a GPParams (or a BatchedGPParams of one model), got "
            f"{params.raw_lengthscale.shape[0]} models; use the *_batch functions"
        )


def nlml(
    params: GPParams,
    x: torch.Tensor,
    y: torch.Tensor,
    noise_var: torch.Tensor,
    kernel=matern32,
    jitter: float = 1e-6,
    *,
    kernel_name: tp.Optional[str] = None,
) -> torch.Tensor:
    """Negative log marginal likelihood of one heteroskedastic-noise GP
    (a scalar, differentiable in ``params``)."""
    _one_model(params)
    t = x.shape[0]
    k = _single_kernel(kernel, kernel_name)(params, x, x)
    ky = k + torch.diag(noise_var) + jitter * torch.eye(t, dtype=k.dtype, device=k.device)
    quad, logdet = linalg_cuda.nlml_terms(ky[None], y[None])
    return 0.5 * (quad[0] + logdet[0] + t * _LOG_2PI)


@torch.no_grad()
def posterior(params: GPParams, x, y, noise_var, kernel=matern32, jitter: float = 1e-6, *,
              kernel_name: tp.Optional[str] = None):
    """Exact posterior (mean ``(T,)``, full covariance ``(T, T)``) of the
    latent f of one model at its training inputs."""
    _one_model(params)
    k = _single_kernel(kernel, kernel_name)(params, x, x)
    mean, cov = _posterior_from_gram(k[None], y[None], noise_var[None], jitter)
    return mean[0], cov[0]


@torch.no_grad()
def posterior_marginals(params: GPParams, x, y, noise_var, kernel=matern32, jitter: float = 1e-6,
                        *, kernel_name: tp.Optional[str] = None):
    """Marginal posterior (mean, variance), each ``(T,)``, of one model
    without forming the full covariance."""
    _one_model(params)
    k = _single_kernel(kernel, kernel_name)(params, x, x)
    mean, var = _marginals_from_gram(k[None], y[None], noise_var[None], jitter)
    return mean[0], var[0]


def fit_gp(
    x: torch.Tensor,
    y: torch.Tensor,
    noise_var: torch.Tensor,
    kernel_name: str = "matern32",
    n_optim_nits: int = 500,
    learning_rate: float = 0.01,
    jitter: float = 1e-6,
) -> tp.Tuple[GPParams, torch.Tensor]:
    """Optimise one model's kernel hyperparameters with Adam on the exact
    NLML: :func:`fit_gp_batch` on a batch of one.  ``kernel_name`` also
    takes the port's kernel callables (:func:`matern32`, :func:`rbf`).
    Returns the fitted :class:`GPParams` and the NLML trace
    ``(n_optim_nits,)``."""
    if callable(kernel_name):
        names = [n for n, f in _KERNELS.items() if f is kernel_name]
        if not names:
            raise ValueError("fit_gp fits the named kernels only: matern32 or rbf")
        kernel_name = names[0]
    params, losses = fit_gp_batch(x[None], y[None], noise_var[None], kernel_name=kernel_name,
                                  n_optim_nits=n_optim_nits, learning_rate=learning_rate,
                                  jitter=jitter)
    return GPParams(params.raw_lengthscale.detach()[0], params.raw_variance.detach()[0]), losses[0]
