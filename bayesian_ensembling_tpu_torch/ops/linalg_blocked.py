"""Recursive blocked NLML terms for the monthly-T regime.

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/linalg_blocked.py``.
Beyond the kernels' shared-memory cap (``linalg_cuda.KERNEL_T_CAP``), a
large float32 batch (``linalg_cuda.linalg_path(t, b)`` returns
``"blocked"``: the monthly campaign's SSP batch, B = 65 at T = 1032, and
its historical chunk, B = 28 at T = 1980) factors each matrix by a
recursive 2x2-block scheme:

  * the ``nb x nb`` diagonal blocks go through the Cholesky kernel
    (``csrc/chol.cu``) and the triangular-inverse kernel
    (``csrc/tri_inv.cu``);
  * everything else is a handful of large batched GEMMs, ``torch.matmul``
    in full float32 (TF32 is off by default), the counterpart of the JAX
    package's ``Precision.HIGHEST``.

The recursion computes ``W = L^-1`` with the factor's log-diagonal, so the
NLML forward is two matrix-vector products, and the custom backward gets
``K^-1 = W^T W`` with no new factorisation.  At T = 1032, padded to 1152,
the recursion has 9 leaves: each NLML evaluation launches 9 Cholesky and 9
triangular-inverse kernels; at T = 1980, padded to 2048, 16 of each.

Layout: ``(B, T, T)`` batch-major throughout.
"""

from __future__ import annotations

import functools
import typing as tp

import torch

from bayesian_ensembling_tpu_torch import _build
from bayesian_ensembling_tpu_torch.ops import linalg_cuda
from bayesian_ensembling_tpu_torch.ops.linalg_cuda import chol, tri_inv

__all__ = ["DEFAULT_BLOCK", "nlml_route", "nlml_terms_blocked"]

# 128: the JAX package's block, which also keeps the diagonal blocks well
# inside the kernels' shared-memory cap (68 KB per block at T = 128 in f32).
DEFAULT_BLOCK = 128


def _pad_to_block(a: torch.Tensor, nb: int) -> tp.Tuple[torch.Tensor, int]:
    """Pad ``(B, T, T)`` to a multiple of ``nb`` with an identity tail (the
    padded matrix stays SPD and the tail's factor is I, so nothing needs
    masking).  Returns the padded tensor and the original T."""
    t = a.shape[-1]
    tp_ = -(-t // nb) * nb
    if tp_ == t:
        return a, t
    out = torch.nn.functional.pad(a, (0, tp_ - t, 0, tp_ - t))
    # A fill of the diagonal's view: no host value is copied to the device,
    # so the fit's step can be captured as a CUDA graph.
    out.diagonal(dim1=-2, dim2=-1)[:, t:].fill_(1.0)
    return out, t


def _diag_chol(block: torch.Tensor) -> torch.Tensor:
    """``(B, nb, nb)`` SPD diagonal block -> lower factor, through the
    Cholesky kernel (its plain version on the CPU)."""
    return chol(block.contiguous())


def _diag_tri_inv(l: torch.Tensor) -> torch.Tensor:
    """``(B, nb, nb)`` lower factor -> L^-1, through the triangular-inverse
    kernel (its plain version on the CPU)."""
    return tri_inv(l.contiguous())


def _rec_inv_logdiag(a: torch.Tensor, nb: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Recursive 2x2-block Cholesky inverse: ``(W = L^-1, sum log diag L)``.

    ::

        [[A, B^T],      L = [[LA,  0 ],     W = [[WA,          0 ],
         [B, C  ]]           [Lb,  LC]]          [-WC Lb WA,   WC]]

        Lb = B WA^T;  S = C - Lb Lb^T;  WC = recurse(S)

    The full factor L is never assembled: the NLML needs only W and L's
    log-diagonal.  ``a`` is ``(B, n, n)`` with n a multiple of ``nb``
    (callers pad with :func:`_pad_to_block`).
    """
    n = a.shape[-1]
    if n <= nb:
        l = _diag_chol(a)
        sld = torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), dim=-1)
        return _diag_tri_inv(l), sld
    h = (n // 2 + nb - 1) // nb * nb
    if h >= n:
        h = n - nb
    wa, sa = _rec_inv_logdiag(a[:, :h, :h], nb)
    lb = torch.matmul(a[:, h:, :h], wa.mT)
    s = a[:, h:, h:] - torch.matmul(lb, lb.mT)
    wc, sc = _rec_inv_logdiag(s, nb)
    w = a.new_zeros(a.shape)
    w[:, :h, :h] = wa
    w[:, h:, :h] = -torch.matmul(wc, torch.matmul(lb, wa))
    w[:, h:, h:] = wc
    return w, sa + sc


def nlml_forward_blocked(ky: torch.Tensor, y: torch.Tensor, nb: int = DEFAULT_BLOCK):
    """The blocked route's NLML forward: ``(quad, logdet, W, alpha)``, with
    W = L^-1 of the unpadded matrix, what the backward needs
    (:func:`nlml_kinv_blocked`).  Counts one ``"blocked"`` route in
    ``_build.ROUTES``, as ``linalg_cuda._routed`` counts the other two."""
    _build.ROUTES["blocked"] += 1
    a, t = _pad_to_block(ky, nb)
    w, sumlog = _rec_inv_logdiag(a, nb)
    # The identity tail adds 0 to the log-diagonal and an identity block
    # to W; the padded y entries are 0, so z and alpha stay 0 there.
    yb = torch.nn.functional.pad(y, (0, a.shape[-1] - t))
    z = torch.einsum("bij,bj->bi", w, yb)
    alpha = torch.einsum("bji,bj->bi", w, z)[:, :t]
    return torch.sum(z * z, dim=-1), 2.0 * sumlog, w[:, :t, :t], alpha


def nlml_kinv_blocked(w: torch.Tensor) -> torch.Tensor:
    """K^-1 = W^T W from the forward's W, with no new factorisation."""
    return torch.matmul(w.mT, w)


def nlml_route(route: str):
    """``(forward, kinv)`` of the NLML on ``route`` (``linalg_cuda.linalg_path``'s
    answer): the recursion's on ``"blocked"``, else ``linalg_cuda``'s (the
    Cholesky-solve kernel, or torch.linalg past its cap).  Every NLML of the
    fit, on the chain or on the Gram kernels, takes its route from here."""
    if route == "blocked":
        return nlml_forward_blocked, nlml_kinv_blocked
    return linalg_cuda.nlml_forward, linalg_cuda.nlml_kinv


def nlml_terms_blocked(
    ky: torch.Tensor, y: torch.Tensor, nb: tp.Optional[int] = None
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Blocked twin of ``linalg_cuda.nlml_terms`` for large T.

    Args:
      ky: ``(B, T, T)`` covariance + noise matrices.
      y: ``(B, T)`` targets.
      nb: diagonal block size; None means :data:`DEFAULT_BLOCK`.

    Returns:
      quad ``(B,)`` = y^T K^-1 y and logdet ``(B,)`` = log|K|, with the same
      custom gradient as ``nlml_terms``.  Each call counts one ``"blocked"``
      route in ``_build.ROUTES``.
    """
    forward = functools.partial(nlml_forward_blocked, nb=DEFAULT_BLOCK if nb is None else nb)
    return linalg_cuda.nlml_terms_on(ky, y, forward, nlml_kinv_blocked)
