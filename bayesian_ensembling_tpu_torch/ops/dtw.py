"""Dynamic Time Warping, classic DTW Barycenter Averaging (DBA) and the
stochastic subgradient DBA.

PyTorch counterpart of ``bayesian_ensembling_tpu/ops/dtw.py``.  The
wavefront DP and the backward on-path sweep are written over a batch of
(centre, series) pairs instead of being vmapped; they are the plain versions
of the DBA-update kernels and of the squared-DTW cost kernel
(``ops/dtw_cuda.py``), which every batched function here calls.

Semantics match the JAX package:
  * squared-Euclidean local cost,
  * move preference on ties: diag, then left, then top,
  * barycentre update = mean of aligned points along the warping path,
  * ``init="mean"``: the masked euclidean mean; ``init="medoid"``: the
    series with the least summed squared-DTW cost to the others.
"""

from __future__ import annotations

import typing as tp

import torch

__all__ = [
    "squared_dtw",
    "squared_dtw_with_path",
    "dtw_pairwise_sq",
    "dba",
    "dba_batch",
    "dba_subgradient_batch",
]

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


def squared_dtw(center: torch.Tensor, series: torch.Tensor) -> torch.Tensor:
    """Squared-DTW alignment cost between two equal-length 1-D series."""
    return _sq_dtw_costs(center[None], series[None])[0]


def squared_dtw_with_path(center: torch.Tensor, series: torch.Tensor):
    """Squared-DTW cost plus the ``(2T-1, T)`` move matrix for backtracking
    (the plain wavefront DP: no kernel outputs the move codes)."""
    total, path = _dtw_scan(center[None], series[None], want_path=True)
    return total[0], path[0]


def _pairwise_costs(series: torch.Tensor) -> torch.Tensor:
    """All-pairs squared-DTW costs of ``(B, R, T)`` stacks, ``(B, R, R)``.

    Squared DTW is symmetric with a zero diagonal (the recurrence mirrors
    under i <-> j, with the same additions in the same order), so only the
    ``B * R(R-1)/2`` upper-triangle pairs run, in one call of the cost
    kernel, and are mirrored.
    """
    b, r, t = series.shape
    d = torch.zeros((b, r, r), dtype=torch.promote_types(series.dtype, torch.float32),
                    device=series.device)
    if r == 1:
        return d
    iu, ju = torch.triu_indices(r, r, offset=1, device=series.device)
    ci = series[:, iu].reshape(-1, t)
    sj = series[:, ju].reshape(-1, t)
    d[:, iu, ju] = _sq_dtw_costs(ci, sj).reshape(b, -1)
    return d + d.transpose(1, 2)


def dtw_pairwise_sq(series: torch.Tensor, mask: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-pairs squared-DTW matrix ``(R, R)`` over a stack of series
    ``(R, T)``; padded rows (mask False) get +inf rows and columns so they
    never win the medoid argmin."""
    d = _pairwise_costs(series[None])[0]
    if mask is not None:
        d = torch.where(mask[:, None] & mask[None, :], d, _INF)
    return d


def _dba_sums_counts(centers: torch.Tensor, xs: torch.Tensor):
    """Aligned-value sums and visit counts for ``N`` (centre, series) pairs,
    ``(N, T) x 2 -> ((N, T), (N, T))``: the DBA-update kernels (the fused
    one within its cap, the split one beyond)."""
    from bayesian_ensembling_tpu_torch.ops.dtw_cuda import dba_update_batch

    return dba_update_batch(centers, xs)


def _sq_dtw_costs(centers: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Squared-DTW costs for ``N`` (centre, series) pairs: ``(N, T) x 2 ->
    (N,)``, through the cost kernel."""
    from bayesian_ensembling_tpu_torch.ops.dtw_cuda import squared_dtw_cost_batch

    return squared_dtw_cost_batch(centers, xs)


def _dba_update(centers: torch.Tensor, series: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One DBA iteration for ``B`` models: align each of the ``R`` series of
    model b to centre b and average the aligned points, honouring the mask.

    ``centers`` ``(B, T)``, ``series`` ``(B, R, T)``, ``mask`` ``(B, R)``.
    All ``B*R`` pairs go through one call of the DBA-update kernel.
    """
    b, r, t = series.shape
    sums, counts = _dba_sums_counts(
        centers.repeat_interleave(r, dim=0).contiguous(), series.reshape(b * r, t)
    )
    w = mask.to(centers.dtype)[:, :, None]
    tot = torch.sum(sums.reshape(b, r, t) * w, dim=1)
    cnt = torch.sum(counts.reshape(b, r, t) * w, dim=1)
    return tot / torch.clamp(cnt, min=1.0)


def dba(
    series: torch.Tensor,
    mask: tp.Optional[torch.Tensor] = None,
    n_iterations: int = 10,
    init: str = "medoid",
    tol: tp.Optional[float] = None,
) -> torch.Tensor:
    """DBA of one stack of equal-length series ``(R, T) -> (T,)``: the
    one-model case of :func:`dba_batch` (``init`` defaults to ``"medoid"``
    here, as in the JAX package)."""
    m = None if mask is None else mask[None]
    return dba_batch(series[None], m, n_iterations=n_iterations, init=init, tol=tol)[0]


def dba_batch(
    series: torch.Tensor,
    mask: tp.Optional[torch.Tensor] = None,
    n_iterations: int = 10,
    init: str = "mean",
    tol: tp.Optional[float] = None,
) -> torch.Tensor:
    """Classic DBA for a batch of models at once: ``(B, R, T) -> (B, T)``.

    ``init="mean"`` starts from the masked euclidean mean; ``init="medoid"``
    from each model's series with the least summed squared-DTW cost to its
    other valid series (all ``B*R(R-1)/2`` costs in one call of the cost
    kernel).  Each update aligns all ``B*R`` pairs in one call of the
    DBA-update kernel.  ``tol`` turns ``n_iterations`` into a cap and
    freezes each model once its barycentre moves less than ``tol``
    (max |delta|) in an iteration; the loop ends when every model is frozen
    (one host sync per iteration).
    """
    if init not in ("mean", "medoid"):
        raise ValueError(f"unknown init {init!r}")
    b, r, t = series.shape
    if mask is None:
        mask = torch.ones((b, r), dtype=torch.bool, device=series.device)
    series = series.contiguous()
    if init == "mean":
        w = mask.to(series.dtype)
        centers = torch.sum(series * w[:, :, None], dim=1) / torch.clamp(
            torch.sum(w, dim=1, keepdim=True), min=1.0
        )
    else:
        d = _pairwise_costs(series)
        ss = torch.sum(torch.where(mask[:, :, None] & mask[:, None, :], d, 0.0), dim=2)
        ss = torch.where(mask, ss, _INF)
        centers = series[torch.arange(b, device=series.device), torch.argmin(ss, dim=1)]
    if tol is None:
        for _ in range(n_iterations):
            centers = _dba_update(centers, series, mask)
        return centers
    done = torch.zeros((b,), dtype=torch.bool, device=series.device)
    for _ in range(n_iterations):
        if bool(done.all()):
            break
        new = _dba_update(centers, series, mask)
        new = torch.where(done[:, None], centers, new)  # freeze converged models
        done = done | (torch.amax(torch.abs(new - centers), dim=1) < tol)
        centers = new
    return centers


def _epoch_orders(seed: int, epoch: int, b: int, r: int) -> torch.Tensor:
    """The ``(B, R)`` orders in which each model visits its series in one
    epoch: a permutation per model, drawn on the CPU from a generator seeded
    by ``(seed, epoch)``, so the card and the CPU take identical orders.
    (JAX's threefry orders cannot be reproduced; the tests put them here.)"""
    gen = torch.Generator().manual_seed(int(seed) * 1_000_003 + int(epoch))
    return torch.stack([torch.randperm(r, generator=gen) for _ in range(b)])


def dba_subgradient_batch(
    series: torch.Tensor,
    mask: tp.Optional[torch.Tensor] = None,
    max_iter: int = 50,
    tol: float = 1e-3,
    initial_step_size: float = 0.05,
    final_step_size: float = 0.005,
    seed: int = 0,
    return_info: bool = False,
):
    """Stochastic subgradient DBA, the variant the reference flagship calls
    (tslearn's ``dtw_barycenter_averaging_subgradient``, Schultz & Jain
    2018), batched over models: ``(B, R, T) -> (B, T)``.

    Per epoch each model visits its series in a fresh random order and
    takes one step per valid series::

        centre <- centre - eta * (V o centre - W.x)

    with V the visit counts and W.x the aligned sums of the classic update
    (one call of the DBA-update kernel for the ``B`` pairs of a step).
    ``eta`` decays linearly from ``initial_step_size`` to
    ``final_step_size`` over ``max_iter * R_valid`` steps per model; padded
    slots are skipped mid-epoch.  After each epoch the Petitjean cost (mean
    squared-DTW of the centre to its series; one call of the cost kernel for
    all ``B*R`` pairs) marks a model done when it changes by less than
    ``tol`` or increases; a done model takes no further step, and the loop
    ends when every model is done (one host sync per epoch) or after
    ``max_iter`` epochs.

    Returns ``(B, T)`` barycentres, plus ``{"epochs", "cost", "converged"}``
    when ``return_info``.
    """
    b, r, t = series.shape
    dev = series.device
    if mask is None:
        mask = torch.ones((b, r), dtype=torch.bool, device=dev)
    dtype = torch.promote_types(series.dtype, torch.float32)
    series = series.to(dtype).contiguous()
    w = mask.to(dtype)
    n_valid = torch.clamp(torch.sum(w, dim=1), min=1.0)

    centers = torch.sum(series * w[:, :, None], dim=1) / n_valid[:, None]
    eta = torch.full((b,), initial_step_size, dtype=dtype, device=dev)
    decay = (initial_step_size - final_step_size) / (max_iter * n_valid)
    s_flat = series.reshape(b * r, t)
    rows = torch.arange(b, device=dev)
    cost = torch.full((b,), _INF, dtype=dtype, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    epochs = 0
    while epochs < max_iter and not bool(done.all()):
        perm = _epoch_orders(seed, epochs, b, r).to(dev)
        for step in range(r):
            idx = perm[:, step]
            valid = mask[rows, idx] & ~done
            sums, counts = _dba_sums_counts(centers, series[rows, idx])
            g = counts * centers - sums
            centers = torch.where(valid[:, None], centers - eta[:, None] * g, centers)
            eta = torch.where(valid, eta - decay, eta)
        crep = centers.repeat_interleave(r, dim=0)
        new_cost = torch.sum(_sq_dtw_costs(crep, s_flat).reshape(b, r) * w, dim=1) / n_valid
        done = done | (torch.abs(cost - new_cost) < tol) | (new_cost > cost)
        cost = new_cost
        epochs += 1
    if return_info:
        return centers, {"epochs": epochs, "cost": cost, "converged": done}
    return centers
