"""Dynamic Time Warping and classic DTW Barycenter Averaging (DBA).

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/dtw.py``, main-path
subset.  The wavefront DP and the backward on-path sweep are written over a
batch of (centre, series) pairs instead of being vmapped; they are the plain
version of the DBA-update kernel (``ops/dtw_cuda.py``).

Semantics match the JAX package:
  * squared-Euclidean local cost,
  * move preference on ties: diag, then left, then top,
  * barycentre update = mean of aligned points along the warping path,
  * ``init="mean"``: the masked euclidean mean.
"""

from __future__ import annotations

import typing as tp

import torch

from bayesian_ensembling_tpu_torch._errors import not_ported

__all__ = ["dba_batch"]

_INF = float("inf")


def _dtw_scan(centers: torch.Tensor, series: torch.Tensor, want_path: bool):
    """Wavefront DP over anti-diagonals for ``N`` pairs of ``(N, T)`` series.

    Returns ``(total (N,), path)`` where ``path`` is an ``(N, 2T-1, T)`` int8
    array of move codes indexed ``path[:, i + j, i]`` with 0=diag, 1=left,
    2=top (row 0 is -1), or None when ``want_path`` is False.
    """
    n, t = centers.shape
    dtype = torch.promote_types(centers.dtype, torch.float32)
    centers = centers.to(dtype)
    series = series.to(dtype)
    rows = torch.arange(t, device=centers.device)
    inf_col = torch.full((n, 1), _INF, dtype=dtype, device=centers.device)

    def shift_down(x):  # x[i] -> x[i-1], +inf into slot 0
        return torch.cat([inf_col, x[:, :-1]], dim=1)

    d = centers[:, 0] - series[:, 0]
    prev1 = torch.full((n, t), _INF, dtype=dtype, device=centers.device)
    prev1[:, 0] = d * d
    prev2 = torch.full_like(prev1, _INF)
    moves = []
    for k in range(1, 2 * t - 1):
        j = k - rows
        valid = (j >= 0) & (j < t)
        d = centers - series[:, j.clamp(0, t - 1)]
        delta = d * d
        diag = shift_down(prev2)  # (i-1, j-1)
        left = prev1  # (i, j-1)
        top = shift_down(prev1)  # (i-1, j)
        take_diag = (diag <= left) & (diag <= top)
        take_left = ~take_diag & (left <= top)
        best = torch.where(take_diag, diag, torch.where(take_left, left, top))
        cur = torch.where(valid, best + delta, _INF)
        if want_path:
            moves.append(
                torch.where(take_diag, 0, torch.where(take_left, 1, 2)).to(torch.int8)
            )
        prev2, prev1 = prev1, cur
    total = prev1[:, t - 1]
    if not want_path:
        return total, None
    first = torch.full((n, 1, t), -1, dtype=torch.int8, device=centers.device)
    return total, torch.cat([first, torch.stack(moves, dim=1)], dim=1) if moves else first


def _backtrack_accumulate(path: torch.Tensor, series: torch.Tensor):
    """Sums of aligned series values and visit counts per centre slot.

    Path membership is propagated backward over anti-diagonals: a cell is on
    the path iff one of its successors is on the path and chose it.

    Args:
      path: ``(N, 2T-1, T)`` move codes, row k = anti-diagonal k, indexed by i.
      series: ``(N, T)``.

    Returns:
      (sums, counts): ``(N, T)`` each.
    """
    n, t = series.shape
    dtype = torch.promote_types(series.dtype, torch.float32)
    series = series.to(dtype)
    rows = torch.arange(t, device=series.device)
    false_col = torch.zeros((n, 1), dtype=torch.bool, device=series.device)

    def shift_up(x):  # x[i] -> x[i+1], False into the last slot
        return torch.cat([x[:, 1:], false_col], dim=1)

    # Diagonal 2T-2 holds only the corner (T-1, T-1), always on the path.
    on_k1 = (rows == t - 1).expand(n, t)
    on_k2 = torch.zeros((n, t), dtype=torch.bool, device=series.device)
    moves_k2 = torch.full((n, t), -1, dtype=torch.int8, device=series.device)
    sums = torch.where(on_k1, series[:, t - 1 : t], 0.0)
    counts = on_k1.to(dtype)
    for k in range(2 * t - 3, -1, -1):
        moves_k1 = path[:, k + 1]
        diag_t = shift_up(on_k2 & (moves_k2 == 0))
        left_t = on_k1 & (moves_k1 == 1)
        top_t = shift_up(on_k1 & (moves_k1 == 2))
        j = k - rows
        valid = (j >= 0) & (j <= t - 1)
        on_k = (diag_t | left_t | top_t) & valid
        sums = sums + torch.where(on_k, series[:, j.clamp(0, t - 1)], 0.0)
        counts = counts + on_k.to(dtype)
        on_k1, on_k2, moves_k2 = on_k, on_k1, moves_k1
    return sums, counts


def _dba_update(centers: torch.Tensor, series: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One DBA iteration for ``B`` models: align each of the ``R`` series of
    model b to centre b and average the aligned points, honouring the mask.

    ``centers`` ``(B, T)``, ``series`` ``(B, R, T)``, ``mask`` ``(B, R)``.
    On CUDA tensors the alignment runs in the DBA-update kernel.
    """
    from bayesian_ensembling_tpu_torch.ops.dtw_cuda import dba_update_batch

    b, r, t = series.shape
    sums, counts = dba_update_batch(
        centers.repeat_interleave(r, dim=0).contiguous(), series.reshape(b * r, t)
    )
    w = mask.to(centers.dtype)[:, :, None]
    tot = torch.sum(sums.reshape(b, r, t) * w, dim=1)
    cnt = torch.sum(counts.reshape(b, r, t) * w, dim=1)
    return tot / torch.clamp(cnt, min=1.0)


def dba_batch(
    series: torch.Tensor,
    mask: tp.Optional[torch.Tensor] = None,
    n_iterations: int = 10,
    init: str = "mean",
    tol: tp.Optional[float] = None,
) -> torch.Tensor:
    """Classic DBA for a batch of models at once: ``(B, R, T) -> (B, T)``.

    ``init="mean"`` starts from the masked euclidean mean; each of the
    ``n_iterations`` updates aligns all ``B*R`` pairs in one call of the
    DBA-update kernel (its plain version on the CPU).
    """
    if init != "mean":
        if init == "medoid":
            raise not_ported("dba_batch(init='medoid')", "A6 (needs kernel B7)")
        raise ValueError(f"unknown init {init!r}")
    if tol is not None:
        raise not_ported("dba_batch(tol=...)", "A6")
    b, r, t = series.shape
    if mask is None:
        mask = torch.ones((b, r), dtype=torch.bool, device=series.device)
    w = mask.to(series.dtype)
    centers = torch.sum(series * w[:, :, None], dim=1) / torch.clamp(
        torch.sum(w, dim=1, keepdim=True), min=1.0
    )
    series = series.contiguous()
    for _ in range(n_iterations):
        centers = _dba_update(centers, series, mask)
    return centers
