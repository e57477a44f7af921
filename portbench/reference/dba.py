"""Classic DTW barycentre averaging (DBA), written from its definition.

The alignment of a centre ``c`` and a series ``s`` (both length T) is the
dynamic programme

    D[i, j] = (c[i] - s[j])^2 + min(D[i-1, j-1], D[i, j-1], D[i-1, j])

with D[0, 0] = (c[0] - s[0])^2.  The warping path is read back from
(T-1, T-1) to (0, 0), each cell taking its cheapest predecessor; on a tie
the diagonal wins, then (i, j-1), then (i-1, j).  One DBA iteration replaces
each centre point i by the mean of the series points aligned to it, over the
real realisations of the model.  The start is the mean of the real
realisations.

Plain PyTorch over a batch of (centre, series) pairs: the table is filled by
anti-diagonals and kept whole (``(N, T+1, T+1)``, a border of +inf), and
the paths are walked back in lock step.  Pairs are taken in blocks so that
the table stays under ``table_bytes``.
"""

from __future__ import annotations

import torch

_INF = float("inf")


def _path_sums(centres: torch.Tensor, series: torch.Tensor):
    """Aligned-value sums and visit counts ``(N, T)`` of each centre slot for
    ``N`` (centre, series) pairs."""
    n, t = centres.shape
    table = torch.full((n, t + 1, t + 1), _INF, dtype=centres.dtype, device=centres.device)
    table[:, 0, 0] = 0.0
    for k in range(2 * t - 1):
        i = torch.arange(max(0, k - t + 1), min(k, t - 1) + 1, device=centres.device)
        j = k - i
        cost = torch.square(centres[:, i] - series[:, j])
        best = torch.minimum(torch.minimum(table[:, i, j], table[:, i + 1, j]), table[:, i, j + 1])
        table[:, i + 1, j + 1] = cost + best
    rows = torch.arange(n, device=centres.device)
    i = torch.full((n,), t - 1, dtype=torch.long, device=centres.device)
    j = i.clone()
    sums = torch.zeros_like(centres)
    counts = torch.zeros_like(centres)
    live = torch.ones((n,), dtype=centres.dtype, device=centres.device)
    for _ in range(2 * t - 1):
        sums[rows, i] += series[rows, j] * live
        counts[rows, i] += live
        diag = table[rows, i, j]  # (i-1, j-1) in the bordered table
        left = table[rows, i + 1, j]  # (i, j-1)
        top = table[rows, i, j + 1]  # (i-1, j)
        take_diag = (diag <= left) & (diag <= top)
        take_left = ~take_diag & (left <= top)
        moving = (i > 0) | (j > 0)
        live = live * moving.to(live.dtype)
        i = torch.where(moving & ~take_left, i - 1, i)
        j = torch.where(moving & (take_diag | take_left), j - 1, j)
    return sums, counts


def path_sums(centres: torch.Tensor, series: torch.Tensor, table_bytes: float = 4e9):
    """:func:`_path_sums` in blocks of pairs whose table fits ``table_bytes``."""
    n, t = centres.shape
    per_pair = (t + 1) ** 2 * centres.element_size()
    block = max(1, int(table_bytes // per_pair))
    parts = [_path_sums(centres[lo:lo + block], series[lo:lo + block]) for lo in range(0, n, block)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def dba(block: torch.Tensor, mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """Classic DBA of ``B`` models, ``(B, R, T)`` realisations (``mask``
    ``(B, R)`` marks the real ones) -> ``(B, T)`` barycentres."""
    b, r, t = block.shape
    w = mask.to(block.dtype)
    centre = torch.einsum("brt,br->bt", block, w) / torch.clamp(w.sum(dim=1), min=1.0)[:, None]
    model, real = torch.nonzero(mask, as_tuple=True)
    series = block[model, real]
    for _ in range(iterations):
        sums, counts = path_sums(centre[model], series)
        total = torch.zeros_like(centre).index_add_(0, model, sums)
        visits = torch.zeros_like(centre).index_add_(0, model, counts)
        centre = total / torch.clamp(visits, min=1.0)
    return centre
