"""Batched small-matrix GP algebra: the fused Cholesky-solve kernel
(``csrc/chol_solve.cu``), the Cholesky kernel (``csrc/chol.cu``), the
triangular-inverse kernel (``csrc/tri_inv.cu``), their plain versions, the
route dispatch :func:`linalg_path` with the routed calls that follow it,
and the NLML terms with their custom gradient.

Counterpart of ``bayesian_ensembling_tpu/ops/linalg_pallas.py``.  The public
wrappers :func:`cholesky_batched`, :func:`cholesky_solve_fused` and
:func:`tri_inv_batched` keep the JAX signatures and their batch-in-lanes
``(T, T, B)`` L^T layout.  The hot path calls the batch-major cores
:func:`chol_solve`, :func:`chol` and :func:`tri_inv` directly on
``(B, T, T)`` tensors, so the optimisation loop does no per-step
transposes.  CUDA tensors go to the kernels; CPU tensors go to the
``*_reference`` functions.

The kernels hold a whole matrix in one block's shared memory, which caps T
(:data:`KERNEL_T_CAP`).  Beyond it :func:`linalg_path` sends the NLML of a
large float32 batch to the recursive blocked NLML (``ops/linalg_blocked.py``,
on the Cholesky and triangular-inverse kernels) and everything else to
``torch.linalg`` ("library"), where the JAX package uses XLA's
decompositions.  :func:`chol_solve_routed`, :func:`tri_inv_routed` and
:func:`cholesky_batched` are the one place that acts on the
kernel-or-library choice: on the library route the plain versions are the
implementation.

Precision: every matrix product here and in ``ops/gp.py`` runs in full
float32 on the card, because ``torch.backends.cuda.matmul.allow_tf32``
defaults to False (float32 matmul precision "highest").  The library never
changes that flag.
"""

from __future__ import annotations

import typing as tp
import warnings

import torch

from bayesian_ensembling_tpu_torch import _build

__all__ = [
    "BLOCKED_DTYPES",
    "BLOCKED_MIN_BATCH",
    "BLOCKED_T_CAP",
    "KERNEL_T_CAP",
    "chol",
    "chol_reference",
    "chol_solve",
    "chol_solve_reference",
    "chol_solve_routed",
    "tri_inv",
    "tri_inv_reference",
    "tri_inv_routed",
    "cholesky_batched",
    "cholesky_solve_fused",
    "tri_inv_batched",
    "linalg_path",
    "nlml_terms",
]


def _kernel_smem_bytes(t: int, itemsize: int) -> int:
    """Shared memory of the larger of the NLML's two kernels at T, as the
    launchers in ``csrc/chol_solve.cu`` and ``csrc/tri_inv.cu`` size it
    (the Cholesky-solve adds one static pivot scalar)."""
    square = t * (t | 1)
    return itemsize * max(square + 4 * t + 1, square + 2 * t)


# Largest T whose fused Cholesky-solve and triangular inverse fit one block's
# shared memory: 239 in float32, 167 in float64.
KERNEL_T_CAP = {
    dtype: _build.largest_t(lambda t, e=dtype.itemsize: _kernel_smem_bytes(t, e))
    for dtype in (torch.float32, torch.float64)
}
# The JAX package's blocked-route gates, kept by name and value
# (linalg_pallas.py:506-511); they were tuned on a TPU v5e and are still to
# be re-decided on the H100.
BLOCKED_T_CAP = 1536
BLOCKED_MIN_BATCH = 64
# The JAX package's blocked route is float32 only (linalg_pallas.py:559-562).
BLOCKED_DTYPES = (torch.float32,)

_warned_routes: set = set()


def linalg_path(t: int, b: tp.Optional[int] = None, dtype: torch.dtype = torch.float32) -> str:
    """Which route the batched linear algebra takes at size ``t``.

    ``"kernel"`` when ``t`` is within :data:`KERNEL_T_CAP` for ``dtype``;
    else ``"blocked"`` (the recursive blocked NLML of
    ``ops/linalg_blocked.py``) when the batch ``b >= BLOCKED_MIN_BATCH``,
    ``t <= BLOCKED_T_CAP`` and the dtype is in :data:`BLOCKED_DTYPES`
    (float32, the JAX package's f32-only rule); else ``"library"``
    (``torch.linalg``).  Only the NLML of the fit has a blocked form, so
    ``b=None`` never returns ``"blocked"``.

    The choice depends on shape and dtype alone, the same on every device.
    It warns once per (T, route) when it leaves the kernels and counts
    nothing: the calls that act on it count the route they took in
    ``_build.ROUTES``.  This is a size dispatch, not a fallback: a kernel
    that fails to build or launch still raises.
    """
    if t <= KERNEL_T_CAP.get(dtype, 0):
        path = "kernel"
    elif (b is not None and b >= BLOCKED_MIN_BATCH and t <= BLOCKED_T_CAP
          and dtype in BLOCKED_DTYPES):
        path = "blocked"
    else:
        path = "library"
    if path != "kernel" and (t, path) not in _warned_routes:
        _warned_routes.add((t, path))
        reasons = [f"T={t} exceeds the kernels' shared-memory cap "
                   f"({KERNEL_T_CAP.get(dtype, 0)} in {dtype})"]
        if path == "library" and b is not None:
            reasons.append(f"the blocked NLML needs float32, T <= {BLOCKED_T_CAP} and a batch "
                           f">= {BLOCKED_MIN_BATCH} (got {dtype}, B={b})")
        warnings.warn(
            "batched linalg: " + "; ".join(reasons) + "; using "
            + ("the recursive blocked NLML on the Cholesky and triangular-inverse kernels"
               if path == "blocked" else "torch.linalg"),
            stacklevel=2,
        )
    return path


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


def chol_reference(ky: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the Cholesky kernel: lower ``L`` of ``ky``
    ``(B, T, T)``, NaN in every entry of a matrix that is not positive
    definite."""
    l, info = torch.linalg.cholesky_ex(ky)
    return torch.where((info > 0)[:, None, None], torch.nan, l)


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


def chol(ky: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``ky`` ``(B, T, T)`` (only the lower
    triangle is read), with zeros above the diagonal.  A non-positive pivot
    gives NaN in that matrix (from that column on in the kernel, everywhere
    in the plain version)."""
    b, t, t2 = ky.shape
    if t != t2:
        raise ValueError(f"expected (B, T, T), got {ky.shape}")
    if ky.device.type == "cpu":
        return chol_reference(ky)
    _build.check_cuda("chol", ky)
    l = torch.empty_like(ky)
    _build.launch(
        "chol", f"bet_chol_{_build.symbol_suffix(ky.dtype)}", ky.data_ptr(), l.data_ptr(), b, t
    )
    return l


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


def _routed(kernel_fn, plain_fn, x: torch.Tensor):
    """``kernel_fn`` where :func:`linalg_path` gives ``"kernel"`` at ``x``'s
    T and dtype, else ``plain_fn`` (torch.linalg); counts the route taken."""
    path = linalg_path(x.shape[-1], dtype=x.dtype)
    _build.ROUTES[path] += 1
    return kernel_fn if path == "kernel" else plain_fn


def chol_solve_routed(ky: torch.Tensor, y: torch.Tensor):
    """:func:`chol_solve` within the kernels' size cap, torch.linalg beyond."""
    return _routed(chol_solve, chol_solve_reference, ky)(ky, y)


def tri_inv_routed(l: torch.Tensor) -> torch.Tensor:
    """:func:`tri_inv` within the kernels' size cap, torch.linalg beyond."""
    return _routed(tri_inv, tri_inv_reference, l)(l)


def cholesky_batched(ky_tlb: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky, JAX layout: ``(T, T, B)`` SPD matrices in,
    ``(T, T, B)`` out with row k = column k of L (the L^T layout).  The
    kernel within its size cap, torch.linalg beyond."""
    ky = ky_tlb.permute(2, 0, 1).contiguous()
    return _routed(chol, chol_reference, ky)(ky).permute(2, 1, 0)


def cholesky_solve_fused(ky_tlb: torch.Tensor, y_tb: torch.Tensor):
    """(L^T-layout factor, z = L^-1 y, alpha = K^-1 y, log|K|), JAX layout:
    the kernel within its size cap, torch.linalg beyond.

    Args:
      ky_tlb: ``(T, T, B)`` SPD matrices, batch last.
      y_tb: ``(T, B)``.

    Returns:
      ``lt (T, T, B)`` with ``lt[k] = L[:, k]``, ``z (T, B)``,
      ``alpha (T, B)``, ``logdet (B,)``.
    """
    ky = ky_tlb.permute(2, 0, 1).contiguous()
    l, z, alpha, logdet = chol_solve_routed(ky, y_tb.T.contiguous())
    return l.permute(2, 1, 0), z.T, alpha.T, logdet


def tri_inv_batched(lt: torch.Tensor) -> torch.Tensor:
    """W = L^-1 for L^T-layout factors ``(T, T, B)``; returns ``(T, T, B)``
    with ``out[i] = row i of W``.  The kernel within its size cap,
    torch.linalg beyond."""
    return tri_inv_routed(lt.permute(2, 1, 0).contiguous()).permute(1, 2, 0)


class _NLMLTerms(torch.autograd.Function):
    """(quad, logdet) with the custom gradient of the JAX package:
    d quad / dK = -alpha alpha^T and d logdet / dK = K^-1 = W^T W."""

    @staticmethod
    def forward(ctx, ky, y):
        l, z, alpha, logdet = chol_solve_routed(ky, y)
        ctx.save_for_backward(l, alpha)
        return torch.sum(z * z, dim=-1), logdet

    @staticmethod
    def backward(ctx, g_quad, g_logdet):
        l, alpha = ctx.saved_tensors
        w = tri_inv_routed(l)
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
      quad ``(B,)`` = y^T K^-1 y and logdet ``(B,)`` = log|K|.  Within the
      kernels' size cap the forward pass is the Cholesky-solve kernel and the
      backward pass the triangular-inverse kernel and K^-1 = W^T W; beyond
      it torch.linalg does both factorisations, with the same gradient.
    """
    return _NLMLTerms.apply(ky, y)
