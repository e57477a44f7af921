"""Batched small-matrix GP algebra: the fused Cholesky-solve kernel
(``csrc/chol_solve.cu``), the triangular-inverse kernel (``csrc/tri_inv.cu``),
their plain versions, and the NLML terms with their custom gradient.

Counterpart of ``bayesian_ensembling_tpu/ops/linalg_pallas.py``.  The public
wrappers :func:`cholesky_solve_fused` and :func:`tri_inv_batched` keep the
JAX signatures and their batch-in-lanes ``(T, T, B)`` L^T layout.  The hot
path calls the batch-major cores :func:`chol_solve` and :func:`tri_inv`
directly on ``(B, T, T)`` tensors, so the optimisation loop does no
per-step transposes.  CUDA tensors go to the kernels; CPU tensors go to the
``*_reference`` functions.

Precision: every matrix product here and in ``ops/gp.py`` runs in full
float32 on the card, because ``torch.backends.cuda.matmul.allow_tf32``
defaults to False (float32 matmul precision "highest").  The library never
changes that flag.
"""

from __future__ import annotations

import typing as tp

import torch

from bayesian_ensembling_tpu_torch import _build

__all__ = [
    "chol_solve",
    "chol_solve_reference",
    "tri_inv",
    "tri_inv_reference",
    "cholesky_solve_fused",
    "tri_inv_batched",
    "nlml_terms",
]


def chol_solve_reference(ky: torch.Tensor, y: torch.Tensor):
    """Plain PyTorch version of the fused kernel: ``(L, z, alpha, logdet)``
    for ``ky`` ``(B, T, T)`` and ``y`` ``(B, T)``.  A matrix that is not
    positive definite gets NaN in every output, as the kernel does."""
    l, info = torch.linalg.cholesky_ex(ky)
    l = torch.where((info > 0)[:, None, None], torch.nan, l)
    z = torch.linalg.solve_triangular(l, y[..., None], upper=False)[..., 0]
    alpha = torch.linalg.solve_triangular(l.mT, z[..., None], upper=True)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), dim=-1)
    return l, z, alpha, logdet


def tri_inv_reference(l: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch W = L^-1 for lower-triangular ``l`` ``(B, T, T)``."""
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device).expand_as(l)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def chol_solve(ky: torch.Tensor, y: torch.Tensor):
    """Cholesky factor, z = L^-1 y, alpha = K^-1 y and log|K| in one pass.

    Args:
      ky: ``(B, T, T)`` symmetric positive-definite matrices (only the lower
        triangle is read).
      y: ``(B, T)`` right-hand sides.

    Returns:
      ``(L (B, T, T) lower with zeros above, z (B, T), alpha (B, T),
      logdet (B,))``.  A non-positive pivot gives NaN.
    """
    b, t, t2 = ky.shape
    if t != t2 or y.shape != (b, t):
        raise ValueError(f"expected (B, T, T) and (B, T), got {ky.shape} and {y.shape}")
    if ky.device.type == "cpu":
        return chol_solve_reference(ky, y)
    _build.check_cuda("chol_solve", ky, y)
    l = torch.empty_like(ky)
    z = torch.empty_like(y)
    alpha = torch.empty_like(y)
    logdet = torch.empty((b,), dtype=ky.dtype, device=ky.device)
    _build.launch(
        "chol_solve",
        f"bet_chol_solve_{_build.symbol_suffix(ky.dtype)}",
        ky.data_ptr(), y.data_ptr(), l.data_ptr(), z.data_ptr(), alpha.data_ptr(),
        logdet.data_ptr(), b, t,
    )
    return l, z, alpha, logdet


def tri_inv(l: torch.Tensor) -> torch.Tensor:
    """W = L^-1 for lower-triangular ``l`` ``(B, T, T)``; W has zeros above
    the diagonal."""
    b, t, t2 = l.shape
    if t != t2:
        raise ValueError(f"expected (B, T, T), got {l.shape}")
    if l.device.type == "cpu":
        return tri_inv_reference(l)
    _build.check_cuda("tri_inv", l)
    w = torch.empty_like(l)
    _build.launch(
        "tri_inv", f"bet_tri_inv_{_build.symbol_suffix(l.dtype)}", l.data_ptr(), w.data_ptr(), b, t
    )
    return w


def cholesky_solve_fused(ky_tlb: torch.Tensor, y_tb: torch.Tensor):
    """(L^T-layout factor, z = L^-1 y, alpha = K^-1 y, log|K|), JAX layout.

    Args:
      ky_tlb: ``(T, T, B)`` SPD matrices, batch last.
      y_tb: ``(T, B)``.

    Returns:
      ``lt (T, T, B)`` with ``lt[k] = L[:, k]``, ``z (T, B)``,
      ``alpha (T, B)``, ``logdet (B,)``.
    """
    l, z, alpha, logdet = chol_solve(
        ky_tlb.permute(2, 0, 1).contiguous(), y_tb.T.contiguous()
    )
    return l.permute(2, 1, 0), z.T, alpha.T, logdet


def tri_inv_batched(lt: torch.Tensor) -> torch.Tensor:
    """W = L^-1 for L^T-layout factors ``(T, T, B)``; returns ``(T, T, B)``
    with ``out[i] = row i of W``."""
    return tri_inv(lt.permute(2, 1, 0).contiguous()).permute(1, 2, 0)


class _NLMLTerms(torch.autograd.Function):
    """(quad, logdet) with the custom gradient of the JAX package:
    d quad / dK = -alpha alpha^T and d logdet / dK = K^-1 = W^T W."""

    @staticmethod
    def forward(ctx, ky, y):
        l, z, alpha, logdet = chol_solve(ky, y)
        ctx.save_for_backward(l, alpha)
        return torch.sum(z * z, dim=-1), logdet

    @staticmethod
    def backward(ctx, g_quad, g_logdet):
        l, alpha = ctx.saved_tensors
        w = tri_inv(l)
        # Full float32 on the card (allow_tf32 is False by default); the TPU
        # ran this product at Precision.DEFAULT.
        kinv = torch.matmul(w.mT, w)
        outer = alpha[:, :, None] * alpha[:, None, :]
        g_ky = g_logdet[:, None, None] * kinv - g_quad[:, None, None] * outer
        g_y = 2.0 * g_quad[:, None] * alpha if ctx.needs_input_grad[1] else None
        return g_ky, g_y


def nlml_terms(ky: torch.Tensor, y: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(quad, logdet) of the Gaussian marginal likelihood, batched.

    Args:
      ky: ``(B, T, T)`` covariance + noise matrices.
      y: ``(B, T)`` targets.

    Returns:
      quad ``(B,)`` = y^T K^-1 y and logdet ``(B,)`` = log|K|.  The forward
      pass is the Cholesky-solve kernel; the backward pass is the
      triangular-inverse kernel and K^-1 = W^T W.
    """
    return _NLMLTerms.apply(ky, y)
