"""The Matern-3/2 Gram of the GP fit and its hyperparameter gradient as two
hand-written kernels (``csrc/gram_matern32.cu``), their plain versions, and
the NLML terms that run on them.

On a card, ``ops/gp._build_batch_step`` hands the Matern-3/2 fit's NLML to
:func:`matern32_nlml_terms`: the build kernel makes ``ky`` from the hoisted
distances, the route's forward factors it (B2 on the kernel route, the
recursive blocked NLML, or ``torch.linalg``), and the backward turns the
route's W into K^-1 and hands it to the contraction kernel, which returns
the two ``(B,)`` gradients (length-scale, variance) without storing the
``(B, T, T)`` gradient of the Gram or any of the chain's temporaries.  On
the CPU the fit keeps PyTorch's autograd chain; CPU tensors given here go
to the ``*_reference`` functions.

Both kernels walk each matrix in ranges of about :data:`GRAM_CHUNK`
elements, one warp a range, so the launch adapts to T alone: at T = 22 and
below a block holds eight matrices, at T = 86 a matrix takes 15 warps, at
T = 1980 it spans 958 blocks.
"""

from __future__ import annotations

import typing as tp

import torch

from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops import linalg_blocked, linalg_cuda

__all__ = [
    "GRAM_CHUNK",
    "gram_matern32",
    "gram_matern32_grad",
    "gram_matern32_grad_reference",
    "gram_matern32_reference",
    "matern32_from_dist",
    "matern32_nlml_terms",
]

SQRT3 = 1.7320508075688772
# Elements of one matrix a warp of either kernel takes: 16 a lane.  Of 256
# to 4,096, the least time of both kernels a step of each benchmark cell on
# an H100, weighed by the cell's launches (in a CUDA graph: annual 70.2 ms
# against 75.3 at 1,024, gridded 85.0 against 90.2, monthly 120.7, the
# least; PERF.md section 6, PR 24).
GRAM_CHUNK = 512


def matern32_from_dist(lengthscale: torch.Tensor, variance: torch.Tensor,
                       dist: torch.Tensor) -> torch.Tensor:
    """``variance (1 + sqrt3 r) exp(-sqrt3 r)``, ``r = dist / lengthscale``,
    for ``(B,)`` hyperparameters and ``(B, N, P)`` distances: the chain the
    fit runs through autograd on the CPU, in its order of operations."""
    r = dist / lengthscale[:, None, None]
    return variance[:, None, None] * (1.0 + SQRT3 * r) * torch.exp(-SQRT3 * r)


def gram_matern32_reference(dist, lengthscale, variance, noise_var, jitter: float):
    """Plain PyTorch version of the build kernel: the Matern-3/2 Gram of
    ``dist`` ``(B, T, T)`` plus ``diag(noise_var)`` and ``jitter I``, added in
    that order."""
    t = dist.shape[-1]
    k = matern32_from_dist(lengthscale, variance, dist)
    return k + torch.diag_embed(noise_var) + jitter * torch.eye(t, dtype=dist.dtype,
                                                               device=dist.device)


def gram_matern32_grad_reference(kinv, alpha, g_quad, g_logdet, dist, lengthscale, variance):
    """Plain PyTorch version of the contraction kernel: ``(g_lengthscale,
    g_variance)``, each ``(B,)``, of ``g_quad quad + g_logdet logdet`` through
    the Matern-3/2 Gram, from K^-1 ``(B, T, T)`` and alpha = K^-1 y ``(B,
    T)``: with G = ``linalg_cuda.nlml_g_ky``, s = sqrt3 dist / lengthscale,
    g_variance = sum G (1 + s) exp(-s) and g_lengthscale = (variance /
    lengthscale) sum G s^2 exp(-s)."""
    g_ky = linalg_cuda.nlml_g_ky(kinv, alpha, g_quad, g_logdet)
    s = SQRT3 * (dist / lengthscale[:, None, None])
    e = torch.exp(-s)
    g_var = torch.sum(g_ky * ((1.0 + s) * e), dim=(1, 2))
    g_ls = variance / lengthscale * torch.sum(g_ky * (s * s * e), dim=(1, 2))
    return g_ls, g_var


def _chunks(t: int) -> int:
    """Ranges a matrix's T x T is cut into: the count depends on T alone, so
    a matrix's gradient does not depend on the batch it is in."""
    return max(1, -(-t * t // GRAM_CHUNK))


def _checked(dist: torch.Tensor, *vectors: torch.Tensor) -> tp.Tuple[int, int]:
    b, t, t2 = dist.shape
    if t != t2:
        raise ValueError(f"expected (B, T, T) distances, got {tuple(dist.shape)}")
    for v in vectors:
        if v.shape[0] != b:
            raise ValueError(f"expected a batch of {b}, got {tuple(v.shape)}")
    return b, t


def gram_matern32(dist, lengthscale, variance, noise_var, jitter: float) -> torch.Tensor:
    """``ky`` ``(B, T, T)``: the Matern-3/2 Gram of the distances ``dist``
    ``(B, T, T)`` at ``lengthscale`` and ``variance`` ``(B,)``, plus
    ``diag(noise_var)`` ``(B, T)`` and ``jitter I``.  CUDA tensors go to the
    build kernel, whose output equals :func:`gram_matern32_reference` bit for
    bit; CPU tensors go to that plain version."""
    b, t = _checked(dist, lengthscale, variance, noise_var)
    if noise_var.shape != (b, t):
        raise ValueError(f"expected ({b}, {t}) noise, got {tuple(noise_var.shape)}")
    if dist.device.type == "cpu":
        return gram_matern32_reference(dist, lengthscale, variance, noise_var, jitter)
    _build.check_cuda("gram_matern32", dist, lengthscale, variance, noise_var)
    ky = torch.empty_like(dist)
    _build.launch(
        "gram_matern32", f"bet_gram_matern32_{_build.symbol_suffix(dist.dtype)}",
        dist.data_ptr(), lengthscale.data_ptr(), variance.data_ptr(), noise_var.data_ptr(),
        ky.data_ptr(), b, t, _chunks(t), float(jitter),
    )
    return ky


def gram_matern32_grad(kinv, alpha, g_quad, g_logdet, dist, lengthscale, variance):
    """``(g_lengthscale, g_variance)`` of :func:`gram_matern32_grad_reference`.
    CUDA tensors go to the contraction kernel (each term in the tensors'
    dtype, the sums in float64 in a fixed order: the same bits every
    launch); CPU tensors go to the plain version."""
    b, t = _checked(dist, kinv, alpha, g_quad, g_logdet, lengthscale, variance)
    if kinv.shape != dist.shape or alpha.shape != (b, t):
        raise ValueError(f"expected K^-1 {tuple(dist.shape)} and alpha ({b}, {t}), got "
                         f"{tuple(kinv.shape)} and {tuple(alpha.shape)}")
    if dist.device.type == "cpu":
        return gram_matern32_grad_reference(kinv, alpha, g_quad, g_logdet, dist, lengthscale,
                                            variance)
    _build.check_cuda("gram_matern32_grad", kinv, alpha, g_quad, g_logdet, dist, lengthscale,
                      variance)
    chunks = _chunks(t)
    partial = torch.empty((b, chunks, 2), dtype=torch.float64, device=dist.device)
    g_ls = torch.empty_like(lengthscale)
    g_var = torch.empty_like(variance)
    _build.launch(
        "gram_matern32_grad", f"bet_gram_matern32_grad_{_build.symbol_suffix(dist.dtype)}",
        kinv.data_ptr(), alpha.data_ptr(), g_quad.data_ptr(), g_logdet.data_ptr(),
        dist.data_ptr(), lengthscale.data_ptr(), variance.data_ptr(), partial.data_ptr(),
        g_ls.data_ptr(), g_var.data_ptr(), b, t, chunks,
    )
    return g_ls, g_var


class _Matern32NLML(torch.autograd.Function):
    """(quad, logdet) of the Matern-3/2 Gram built by :func:`gram_matern32`,
    through the route's forward; the backward is the route's K^-1 and
    :func:`gram_matern32_grad`.  Saved: the route's factor (L, or W on the
    blocked route) and alpha, besides the inputs."""

    @staticmethod
    def forward(ctx, dist, lengthscale, variance, noise_var, y, jitter, route):
        forward, ctx.kinv = linalg_blocked.nlml_route(route)
        quad, logdet, factor, alpha = forward(
            gram_matern32(dist, lengthscale, variance, noise_var, jitter), y)
        ctx.save_for_backward(factor, alpha, dist, lengthscale, variance)
        return quad, logdet

    @staticmethod
    def backward(ctx, g_quad, g_logdet):
        factor, alpha, dist, lengthscale, variance = ctx.saved_tensors
        g_quad, g_logdet, alpha = g_quad.contiguous(), g_logdet.contiguous(), alpha.contiguous()
        g_ls, g_var = gram_matern32_grad(ctx.kinv(factor), alpha, g_quad, g_logdet, dist,
                                         lengthscale, variance)
        g_y = linalg_cuda.nlml_g_y(alpha, g_quad) if ctx.needs_input_grad[4] else None
        return None, g_ls, g_var, None, g_y, None, None


def matern32_nlml_terms(dist, lengthscale, variance, noise_var, y, jitter: float, route: str):
    """(quad, logdet) of ``ky = gram_matern32(dist, lengthscale, variance,
    noise_var, jitter)`` on ``route`` (``linalg_cuda.linalg_path``'s
    answer), differentiable in ``lengthscale``, ``variance`` and ``y``.

    The values equal ``linalg_cuda.nlml_terms`` (or
    ``linalg_blocked.nlml_terms_blocked``) of the chain's Gram bit for bit,
    and the route (``linalg_blocked.nlml_route``) counts in ``_build.ROUTES``
    as there; the gradients differ from autograd of the chain only in the
    order of summation."""
    return _Matern32NLML.apply(dist, lengthscale.contiguous(), variance.contiguous(),
                               noise_var.contiguous(), y, jitter, route)
