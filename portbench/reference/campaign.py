"""The native-monthly dedup campaign's whole step, written from its definition.

Each unique historical model and each listed (scenario, model) SSP run is
emulated once (classic DBA target, the exact GP fit, its posterior
marginals: ``gp.emulate``), the marginals are laid out by scenario, padded
to ``M`` models, and the CRPS weights and the W2 barycentre are taken a
scenario (``tail``).

The DBA is ``dba.dba``'s, bit for bit, with its alignment tables filled in
blocks of ``TABLE_BYTES`` (at T = 1980 in float64 one pair's table is 31.4
MB, so the campaign's few hundred pairs a collection fit in one or two
blocks) and walked in fewer host calls (:func:`_path_sums`): at monthly T
its Python loop, one step per anti-diagonal and one per step of the path,
sets the reference's time.
"""

from __future__ import annotations

import torch

from portbench.reference import gp, steps, tail

TABLE_BYTES = 16e9


def _path_sums(centres: torch.Tensor, series: torch.Tensor):
    """``dba._path_sums``: the same table, path and sums, bit for bit.

    Anti-diagonal k of a pair's bordered table, its cells (i + 1, k - i + 1),
    lies at flat positions a step of T apart, as do its three predecessors,
    so each is read and written as a strided view, and the series is read
    reversed so that its points along the diagonal are a slice.  The path is
    walked on flat indices: the three neighbours in one ``take``, the sums
    and counts by ``index_add_`` (one index a pair, so in the same order);
    (0, 0) holds the path once it is reached, where it stops counting."""
    n, t = centres.shape
    w = t + 1
    like = dict(dtype=centres.dtype, device=centres.device)
    table = torch.full((n, w, w), float("inf"), **like)
    table[:, 0, 0] = 0.0
    flat = table.view(n, w * w)
    rev = series.flip(-1)
    for k in range(2 * t - 1):
        lo, hi = max(0, k - t + 1), min(k, t - 1)

        def diagonal(start, m=hi - lo + 1):
            return flat.as_strided((n, m), (w * w, t), start)

        at = w + 1 + k + lo * t  # the cell (lo + 1, k - lo + 1)
        cost = torch.square(centres[:, lo:hi + 1] - rev[:, t - 1 - k + lo:t - k + hi])
        best = torch.minimum(torch.minimum(diagonal(at - w - 1), diagonal(at - 1)),
                             diagonal(at - w))
        diagonal(at).copy_(cost + best)
    rows = torch.arange(n, device=centres.device)
    base, srow = rows * (w * w), rows * t
    around = torch.tensor([0, w, 1], device=centres.device)  # (i-1, j-1), (i, j-1), (i-1, j)
    i = torch.full((n,), t - 1, dtype=torch.long, device=centres.device)
    j = i.clone()
    sums = torch.zeros_like(centres)
    counts = torch.zeros_like(centres)
    live = torch.ones((n,), **like)
    for _ in range(2 * t - 1):
        slot = srow + i
        sums.view(-1).index_add_(0, slot, torch.take(series, srow + j) * live)
        counts.view(-1).index_add_(0, slot, live)
        diag, left, top = torch.take(table, (base + i * w + j)[:, None] + around).unbind(1)
        take_diag = (diag <= left) & (diag <= top)
        take_left = ~take_diag & (left <= top)
        live = live * (i + j > 0)
        i = torch.clamp(i - (~take_left).long(), min=0)
        j = torch.clamp(j - (take_diag | take_left).long(), min=0)
    return sums, counts


def _blocked_path_sums(centres, series):
    """:func:`_path_sums` in blocks of pairs whose tables fit ``TABLE_BYTES``."""
    n, t = centres.shape
    block = max(1, int(TABLE_BYTES // ((t + 1) ** 2 * centres.element_size())))
    parts = [_path_sums(centres[lo:lo + block], series[lo:lo + block])
             for lo in range(0, n, block)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _dba(block, mask, iterations):
    """:func:`dba.dba` with :func:`_blocked_path_sums`."""
    w = mask.to(block.dtype)
    centre = torch.einsum("brt,br->bt", block, w) / torch.clamp(w.sum(dim=1), min=1.0)[:, None]
    model, real = torch.nonzero(mask, as_tuple=True)
    series = block[model, real]
    for _ in range(iterations):
        sums, counts = _blocked_path_sums(centre[model], series)
        total = torch.zeros_like(centre).index_add_(0, model, sums)
        visits = torch.zeros_like(centre).index_add_(0, model, counts)
        centre = total / torch.clamp(visits, min=1.0)
    return centre


def _slots(members, m):
    """Gather maps ``(S, M)`` from scenario slots into the unique historical
    models and into the SSP rows, and the model mask: slot j of scenario s
    is its j-th listed model; a padded slot reads model 0 and SSP row 0 (any
    real fit: its weight is zero)."""
    s, _ = members.shape
    hidx = torch.zeros((s, m), dtype=torch.long, device=members.device)
    sidx = torch.zeros_like(hidx)
    mask = torch.zeros((s, m), dtype=torch.bool, device=members.device)
    row = 0
    for si in range(s):
        listed = torch.nonzero(members[si]).flatten()
        n = listed.numel()
        hidx[si, :n] = listed
        sidx[si, :n] = torch.arange(row, row + n, device=members.device)
        mask[si, :n] = True
        row += n
    return hidx, sidx, mask


@torch.no_grad()
def campaign(inputs, config, profile, device, dtype=torch.float64):
    """Returns ``(bary_mean (S, T_ssp), bary_std (S, T_ssp), weights (S, M))``."""
    steps._supported(config)
    hist, hmask, members, ssp, obs = (steps._tensor(inputs[k], dtype, device) for k in
                                      ("hist", "hist_mask", "members", "ssp", "obs"))
    kernel, jitter = config["kernel"], config["jitter"]
    h_mean, h_var = gp.emulate(hist, hmask, profile, kernel, jitter, _dba)  # (U, T_hist)
    model = torch.nonzero(members)[:, 1]  # each SSP row's historical model
    s_mean, s_var = gp.emulate(ssp, hmask[model], profile, kernel, jitter, _dba)  # (B_ssp, T)
    hidx, sidx, mask = _slots(members, config["shape"]["models"])
    w = tail.weights(h_mean[hidx.T], h_var[hidx.T], obs, mask.T.to(dtype))  # (M, S)
    mean, std = tail.barycentre(w, s_mean[sidx.T], s_var[sidx.T])
    return steps._numpy(mean, std, w.T)
