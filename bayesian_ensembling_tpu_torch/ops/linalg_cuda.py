"""Batched small-matrix GP algebra: the fused Cholesky-solve kernel
(``csrc/chol_solve.cu``), the Cholesky kernel (``csrc/chol.cu``), the
triangular-inverse kernel (``csrc/tri_inv.cu``), the vector-solve kernel
(``csrc/solve_vec.cu``), their plain versions, the
route dispatch :func:`linalg_path` with the routed calls that follow it,
and the NLML terms with their custom gradient.

Counterpart of ``bayesian_ensembling_tpu/ops/linalg_pallas.py``.  The public
wrappers :func:`cholesky_batched`, :func:`cholesky_solve_fused`,
:func:`solve_vec_batched` and :func:`tri_inv_batched` keep the JAX
signatures and their batch-in-lanes ``(T, T, B)`` L^T layout.  The hot path
calls the batch-major cores :func:`chol_solve`, :func:`chol`,
:func:`solve_vec` and :func:`tri_inv` directly on
``(B, T, T)`` tensors, so the optimisation loop does no per-step
transposes.  CUDA tensors go to the kernels; CPU tensors go to the
``*_reference`` functions.

The factorising kernels hold a whole matrix in one block's shared memory,
which caps T (:data:`KERNEL_T_CAP`); the vector solve holds the packed
triangle of its factor there up to :data:`SOLVE_VEC_RESIDENT_T_CAP` and
streams it through a ring of row panels beyond, up to
:data:`SOLVE_VEC_T_CAP`.  Beyond :data:`KERNEL_T_CAP` :func:`linalg_path`
sends the NLML of a
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
    "SOLVE_VEC_T_CAP",
    "chol",
    "chol_reference",
    "chol_routed",
    "chol_solve",
    "chol_solve_composed",
    "chol_solve_reference",
    "chol_solve_routed",
    "solve_vec",
    "solve_vec_reference",
    "solve_vec_batched",
    "tri_inv",
    "tri_inv_reference",
    "tri_inv_routed",
    "cholesky_batched",
    "cholesky_solve_fused",
    "tri_inv_batched",
    "linalg_path",
    "nlml_terms",
]


def _smem_ld(t: int, itemsize: int) -> int:
    """Leading dimension of a T x T matrix in the kernels' shared memory, as
    ``smem_ld`` of ``csrc/warp_tile.cuh`` computes it: rows start on 16-byte
    boundaries and are not a multiple of 128 bytes long."""
    vec = 16 // itemsize
    ld = -(-t // vec) * vec
    if ld * itemsize % 128 == 0:
        ld += vec
    return ld


def _kernel_smem_bytes(t: int, itemsize: int) -> int:
    """Shared memory of the larger of the NLML's two kernels at T, as the
    launchers size it: the fused Cholesky-solve (``csrc/chol_solve.cu``)
    holds the matrix, two T-vectors and the factorisation body's 96
    values of static scratch (``csrc/chol_factorise.cuh``); the triangular
    inverse (``csrc/tri_inv.cu``) holds the matrix alone, and the Cholesky
    (``csrc/chol.cu``) the matrix and the 96 values."""
    return itemsize * (t * _smem_ld(t, itemsize) + 2 * t + 96)


# Largest T whose fused Cholesky-solve and triangular inverse fit one block's
# shared memory: 239 in float32, 168 in float64.
KERNEL_T_CAP = {
    dtype: _build.largest_t(lambda t, e=dtype.itemsize: _kernel_smem_bytes(t, e))
    for dtype in (torch.float32, torch.float64)
}


def _solve_vec_resident_smem_bytes(t: int, itemsize: int) -> int:
    """Shared memory of the vector solve's resident layout at T, as the
    launcher in ``csrc/solve_vec.cu`` sizes it: 128 bytes of mbarriers (one
    a 32-row panel), three T-vectors (the right-hand side, the forward
    sums, the reciprocals of the diagonal) each rounded up to 16 bytes, and
    the packed lower triangle, T (T + 1) / 2 values."""
    return 128 + 3 * (-(-itemsize * t // 16) * 16) + itemsize * (t * (t + 1) // 2)


# Stages of the streamed layout's ring, and the bytes of one: a tile of 32
# rows of W columns (W = 128 in float32, 64 in float64), dense.
SOLVE_VEC_STAGES = 6
_SOLVE_VEC_STAGE_BYTES = 16384


def _solve_vec_chunk_width(itemsize: int) -> int:
    """W: the columns of one stage, and the streamed layout's consumer threads."""
    return _SOLVE_VEC_STAGE_BYTES // (32 * itemsize)


def _solve_vec_streamed_smem_bytes(t: int, itemsize: int) -> int:
    """Shared memory of the streamed layout at T: the ring, 256 bytes of
    mbarriers and counters, the consumers' dot products of two panels (32
    values a consumer warp each), and one T-vector (z, then alpha)."""
    dots = itemsize * 2 * _solve_vec_chunk_width(itemsize)
    return SOLVE_VEC_STAGES * _SOLVE_VEC_STAGE_BYTES + 256 + dots + -(-itemsize * t // 16) * 16


# Largest T of the resident layout: 337 in float32, 237 in float64 (every
# library shape); beyond it the streamed layout, up to SOLVE_VEC_T_CAP:
# 33,216 in float32, 16,608 in float64.
SOLVE_VEC_RESIDENT_T_CAP = {
    dtype: _build.largest_t(lambda t, e=dtype.itemsize: _solve_vec_resident_smem_bytes(t, e))
    for dtype in (torch.float32, torch.float64)
}
SOLVE_VEC_T_CAP = {
    dtype: _build.largest_t(lambda t, e=dtype.itemsize: _solve_vec_streamed_smem_bytes(t, e))
    for dtype in (torch.float32, torch.float64)
}
# The blocked-route gates, the H100's values (the JAX package's names; its
# TPU v5e values were 1536 and 64).  Set from one float32 NLML value and
# gradient, eager and in a CUDA graph, and one graphed Adam step of the fit,
# on both routes over B in {4, 8, 16, 28, 65, 112} and T in {240, 512, 1032,
# 1536, 1980, 2400, 3012} (``python3 -m
# bayesian_ensembling_tpu_torch.utils.linalg_route_times``; the table is in
# PERF.md section 6).  In a graph, as the Adam fit runs, the blocked route is
# the faster at every measured shape (1.46-1.94x at B >= 28, T >= 1032), and
# from T = 1536 on it also holds less memory at its peak.  Eagerly, T <= 1032
# is host-bound and either route may win; at B <= 16 the library route is as
# fast there in several cells and holds less memory at T <= 512, so the
# batch gate keeps the small batches on it.  The cap is the largest T
# measured: nothing beyond it was timed.
BLOCKED_T_CAP = 3012
BLOCKED_MIN_BATCH = 28
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


def solve_vec_reference(l: torch.Tensor, y: torch.Tensor):
    """Plain PyTorch version of the vector-solve kernel: ``(z, alpha,
    logdet)`` for lower factors ``l`` ``(B, T, T)`` and ``y`` ``(B, T)``,
    by two ``solve_triangular`` calls and the log of the diagonal."""
    z = torch.linalg.solve_triangular(l, y[..., None], upper=False)[..., 0]
    alpha = torch.linalg.solve_triangular(l.mT, z[..., None], upper=True)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), dim=-1)
    return z, alpha, logdet


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
    gives NaN in that matrix only (from that column on in the kernel,
    everywhere in the plain version)."""
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


def _solve_vec_layout(t: int, dtype: torch.dtype) -> str:
    """``"resident"`` (the packed triangle in shared memory) up to
    :data:`SOLVE_VEC_RESIDENT_T_CAP`, else ``"streamed"`` (a ring of row
    panels); the launch raises past :data:`SOLVE_VEC_T_CAP`."""
    return "resident" if t <= SOLVE_VEC_RESIDENT_T_CAP.get(dtype, 0) else "streamed"


def _solve_vec_checked(l: torch.Tensor, y: torch.Tensor) -> None:
    b, t, t2 = l.shape
    if t != t2 or y.shape != (b, t):
        raise ValueError(f"expected (B, T, T) and (B, T), got {l.shape} and {y.shape}")


def _launch_solve_vec(l: torch.Tensor, y: torch.Tensor, forward_only: bool):
    """One launch of the vector-solve kernel: ``(z, alpha or None, logdet)``."""
    b, t = l.shape[0], l.shape[1]
    _build.check_cuda("solve_vec", l, y)
    z = torch.empty_like(y)
    alpha = None if forward_only else torch.empty_like(y)
    logdet = torch.empty((b,), dtype=l.dtype, device=l.device)
    flags = int(forward_only) | (2 if _solve_vec_layout(t, l.dtype) == "streamed" else 0)
    _build.launch(
        "solve_vec",
        f"bet_solve_vec_{_build.symbol_suffix(l.dtype)}",
        l.data_ptr(), y.data_ptr(), z.data_ptr(), 0 if alpha is None else alpha.data_ptr(),
        logdet.data_ptr(), b, t, flags,
    )
    return z, alpha, logdet


def solve_vec(l: torch.Tensor, y: torch.Tensor):
    """Both substitutions and the log-determinant for given factors.

    Args:
      l: ``(B, T, T)`` lower-triangular factors, batch-major as :func:`chol`
        returns them (only the lower triangle is read).
      y: ``(B, T)`` right-hand sides.

    Returns:
      ``(z (B, T) = L^-1 y, alpha (B, T) = L^-T z, logdet (B,) =
      2 sum_i log L_ii)``.  CUDA tensors go to the vector-solve kernel
      (T up to :data:`SOLVE_VEC_T_CAP`; the launch raises beyond), CPU
      tensors to :func:`solve_vec_reference`.  Nothing is trapped: a zero
      diagonal entry gives inf or NaN in ``z`` and ``alpha`` of that matrix
      and ``-inf`` in its ``logdet``, a negative or NaN one gives NaN in
      ``logdet``, as in the plain version; the other matrices of the batch
      are unaffected.
    """
    _solve_vec_checked(l, y)
    if l.device.type == "cpu":
        return solve_vec_reference(l, y)
    return _launch_solve_vec(l, y, forward_only=False)


def solve_vec_forward(l: torch.Tensor, y: torch.Tensor):
    """``(z, logdet)`` of :func:`solve_vec` without alpha: the same kernel
    with its backward pass off (one launch, counted as a ``solve_vec``
    launch), for callers that drop alpha.  z and logdet equal the full
    launch's bit for bit.  Internal to the port: not in ``__all__``."""
    _solve_vec_checked(l, y)
    if l.device.type == "cpu":
        z, _, logdet = solve_vec_reference(l, y)
        return z, logdet
    z, _, logdet = _launch_solve_vec(l, y, forward_only=True)
    return z, logdet


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


def chol_routed(ky: torch.Tensor) -> torch.Tensor:
    """:func:`chol` within the kernels' size cap, torch.linalg beyond."""
    return _routed(chol, chol_reference, ky)(ky)


def chol_solve_composed(ky: torch.Tensor, y: torch.Tensor):
    """``(L, z, alpha, logdet)`` as :func:`chol_solve` returns them, composed
    from :func:`chol_routed` and :func:`solve_vec`: the form the JAX
    package's ``cholesky_solve_fused`` takes off the TPU, and what the
    library API does with a posterior covariance (factor once, solve
    against the factor)."""
    l = chol_routed(ky)
    return (l, *solve_vec(l, y))


def tri_inv_routed(l: torch.Tensor) -> torch.Tensor:
    """:func:`tri_inv` within the kernels' size cap, torch.linalg beyond."""
    return _routed(tri_inv, tri_inv_reference, l)(l)


def cholesky_batched(ky_tlb: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky, JAX layout: ``(T, T, B)`` SPD matrices in,
    ``(T, T, B)`` out with row k = column k of L (the L^T layout).  The
    kernel within its size cap, torch.linalg beyond."""
    return chol_routed(ky_tlb.permute(2, 0, 1).contiguous()).permute(2, 1, 0)


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


def solve_vec_batched(lt: torch.Tensor, y_tb: torch.Tensor):
    """Solve L z = y and L^T alpha = z for every batch lane, and log|LL^T|,
    JAX layout.

    Args:
      lt: ``(T, T, B)`` L^T-layout Cholesky factors (``lt[k] = L[:, k]``).
      y_tb: ``(T, B)`` right-hand sides.

    Returns:
      ``(z (T, B), alpha (T, B), logdet (B,))``.
    """
    z, alpha, logdet = solve_vec(lt.permute(2, 1, 0).contiguous(), y_tb.T.contiguous())
    return z.T, alpha.T, logdet


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
