"""Gridded emulation: every (model, cell) pair an independent DBA + GP fit.

PyTorch counterpart of ``bayesian_ensembling_tpu/parallel/gridded.py``,
unsharded.  The gridded experiment (``GPDTW3D`` batched mode,
``models/gp_3d.py``) fits each (lat, lon) cell of each model on its own:
:func:`gridded_ensemble_step` merges the (model, cell) axes into one batch
of ``M*C`` emulators (``parallel/step.emulate_marginals``: the DBA-update
kernel, then the Cholesky-solve and triangular-inverse kernels in every
NLML step and in the posterior), then :func:`gridded_tail` weights the
models per cell and point and forms the per-cell W2 barycentre.
:func:`refined_gridded_f64` re-runs the posterior and the tail in float64
at given hyperparameters and targets; :func:`coarse_warm_start` fits a
strided coarse grid and hands each fine cell its nearest coarse cell's
hyperparameters as a warm start.

Gridded hyperparameters are a
:class:`~bayesian_ensembling_tpu_torch.ops.gp.BatchedGPParams` with
``(M, C)`` leaves, as the JAX ``GPParams`` has there.

On a device mesh (``parallel/mesh.py``) the cells are collective-free data
parallelism: :func:`sharded_gridded_marginals` emulates each rank's cells,
:func:`make_sharded_gridded_step` shards the (model, cell) axes of the whole
step, the model axis coupling only at the weight total and the barycentre
sums, and ``coarse_warm_start(mesh=...)`` shards the coarse fit.
"""

from __future__ import annotations

import functools
import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import resolve_device
from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
from bayesian_ensembling_tpu_torch.parallel.mesh import (
    _tensor_on,
    all_gather,
    axis_size,
    mesh_device,
    psum,
    shard_map,
)
from bayesian_ensembling_tpu_torch.parallel.step import (
    _PAIRWISE,
    _check_step_options,
    _gather_models,
    _loglik,
    _shifted_exp,
    _similarity,
    _to,
    emulate_marginals,
    fused_raw_weights,
)
from bayesian_ensembling_tpu_torch.utils.profiling import span

__all__ = [
    "pad_cells",
    "sharded_gridded_marginals",
    "gridded_tail",
    "gridded_ensemble_step",
    "refine_marginals_f64",
    "refined_gridded_f64",
    "make_sharded_gridded_step",
    "coarse_cell_indices",
    "coarse_fit_params",
    "coarse_warm_start",
]


def pad_cells(
    block: np.ndarray, mask: np.ndarray, n_devices: int
) -> tp.Tuple[np.ndarray, np.ndarray, int]:
    """Pad the leading cells axis to a multiple of ``n_devices``.

    Padded cells replicate cell 0 (cheap, numerically safe); callers slice
    the outputs back to the returned original count.
    """
    c = block.shape[0]
    target = -(-c // n_devices) * n_devices
    if target == c:
        return block, mask, c
    reps = target - c
    block = np.concatenate([block, np.repeat(block[:1], reps, axis=0)], axis=0)
    mask = np.concatenate([mask, np.repeat(mask[:1], reps, axis=0)], axis=0)
    return block, mask, c


def sharded_gridded_marginals(
    mesh,
    block,  # (C, R, T) per-cell realisation stacks
    mask,  # (C, R)
    axis: str = "cells",
    gp_init: tp.Optional[gp_ops.BatchedGPParams] = None,  # (C,) warm start
    **emulate_kwargs,
):
    """Emulate every cell, the cells sharded over the ``axis`` of ``mesh``;
    returns ``(mean, var)`` ``(C, T)`` as ``DTensor``s sharded over ``axis``.

    Every rank passes the same global arrays (``C`` a multiple of the axis
    size, see :func:`pad_cells`) and runs the whole emulation, the kernels
    included, on its block of cells, with no collective.  ``gp_init``
    warm-starts each cell's fit; its leaves are sharded with the cells.
    """

    def fn(b, m, ls, var):
        init = None if ls is None else gp_ops.BatchedGPParams(ls, var)
        return emulate_marginals(b, m, gp_init=init, **emulate_kwargs)

    p = (axis,)
    leaves = (None, None) if gp_init is None else _leaves(gp_init)
    return shard_map(fn, mesh, (p, p, p, p), (p, p), pad={axis: "pad_cells"})(block, mask, *leaves)


def make_sharded_gridded_step(
    mesh,
    model_axis: str = "model",
    cells_axis: str = "cells",
    *,
    weight_kind: str = "crps",
    with_gp_init: bool = False,
    **emulate_kwargs,
):
    """The gridded step on a 2-D ``(model, cells)`` mesh: cells and models
    sharded at once.

    Returns ``step(block, obs, mask, model_mask)`` of the global arrays
    (``M`` and ``C`` multiples of their axes' sizes, see :func:`pad_cells`
    and ``parallel.step.pad_models``); with ``with_gp_init=True`` it takes a
    fifth argument, the ``(M, C)`` warm start, sharded like the data.  The
    cells are collective-free; the model axis couples only at the weight
    total and the barycentre sums, ``psum``s over ``model_axis``.  Returns
    ``(bary_mean (C, T), bary_std (C, T))`` as ``DTensor``s sharded over
    ``cells_axis`` (replicated over the models) and ``weights (M, C)``
    sharded over both.  ``**emulate_kwargs`` are
    :func:`gridded_ensemble_step`'s (``sigma_mode`` included).
    """
    _check_step_options(weight_kind, emulate_kwargs.get("sigma_mode", "w2"), None)

    def fn(block, obs, mask, model_mask, ls=None, var=None):
        init = None if ls is None else gp_ops.BatchedGPParams(ls, var)
        return gridded_ensemble_step(block, obs, mask, model_mask, weight_kind=weight_kind,
                                     model_axis=model_axis, gp_init=init, **emulate_kwargs)

    p_mc, p_c = (model_axis, cells_axis), (cells_axis,)
    in_specs = (p_mc, p_c, p_mc, (model_axis,)) + ((p_mc, p_mc) if with_gp_init else ())
    smapped = shard_map(fn, mesh, in_specs, (p_c, p_c, p_mc),
                        pad={model_axis: "pad_models", cells_axis: "pad_cells"})
    if not with_gp_init:
        return smapped

    def step(block, obs, mask, model_mask, gp_init: gp_ops.BatchedGPParams):
        return smapped(block, obs, mask, model_mask, *_leaves(gp_init))

    return step


def _leaves(params: gp_ops.BatchedGPParams):
    """The detached leaves ``(raw_lengthscale, raw_variance)``."""
    return params.raw_lengthscale.detach(), params.raw_variance.detach()


def _reshape_params(params: gp_ops.BatchedGPParams, *shape: int) -> gp_ops.BatchedGPParams:
    """A detached copy of ``params`` with its leaves reshaped to ``shape``."""
    return gp_ops.BatchedGPParams(params.raw_lengthscale.detach().reshape(shape),
                                  params.raw_variance.detach().reshape(shape))


def gridded_tail(
    mean: torch.Tensor,  # (M, C, T) posterior marginal means
    var: torch.Tensor,  # (M, C, T) marginal variances incl. noise
    obs: torch.Tensor,  # (C, R_obs, T)
    block: torch.Tensor,  # (M, C, R, T) raw realisations (inverse_square only)
    mask: torch.Tensor,  # (M, C, R)
    model_mask: tp.Optional[torch.Tensor] = None,  # (M,)
    *,
    weight_kind: str = "crps",
    sigma_mode: str = "w2",
    model_axis: tp.Optional[str] = None,
):
    """Per-cell weights and W2 barycentre from gridded posterior marginals.

    The raw scores of ``fused_raw_weights`` (written for one cell's
    ``(M, T)``) are mapped over the cell axis with ``torch.func.vmap``, as
    the JAX package maps them with ``jax.vmap``; the scores are normalised
    over the models per cell and point, averaged over time, and the
    barycentre is the weighted mean and, for ``sigma_mode="w2"``, the
    weighted mean of the marginal stds (``"mixture"``: the moment-matched
    mixture's).  The dtype follows the inputs, so the float64 refinement
    runs this same tail.  Returns ``(bary_mean (C, T), bary_std (C, T),
    weights (M, C))``.

    With ``model_axis`` (the models sharded over that mesh axis) the weight
    total and the barycentre sums are ``psum``s over it; the ``loglik`` max
    (a ``pmax``) and the similarity kinds' gathers are issued once for all
    cells, as ``jax.vmap`` batches them.
    """
    _check_step_options(weight_kind, sigma_mode, model_axis)
    m, c, t = mean.shape
    with span("tail", mean, B=m * c, T=t, weight_kind=weight_kind):
        cells = functools.partial(torch.func.vmap, out_dims=1)
        if weight_kind == "loglik":
            ll = cells(lambda mu, v, o: _loglik(mu, v, o, model_mask),
                       in_dims=(1, 1, 0))(mean, var, obs)
            raw = _shifted_exp(ll, 0, model_axis)  # (M, C, T)
        elif weight_kind in _PAIRWISE:
            std = torch.sqrt(var)
            mean_all, std_all, mask_all = _gather_models(mean, std, model_mask, model_axis, 0)
            raw = cells(lambda mu, sd, mu_all, sd_all: _similarity(weight_kind, mu, sd, mu_all,
                                                                   sd_all, mask_all),
                        in_dims=(1, 1, 1, 1))(mean, std, mean_all, std_all)
        else:
            raw = cells(lambda mu, v, o, b, mk: fused_raw_weights(weight_kind, mu, v, o, b, mk,
                                                                  model_mask),
                        in_dims=(1, 1, 0, 1, 1))(mean, var, obs, block, mask)
        if model_mask is not None:
            raw = raw * model_mask[:, None, None]
        w = torch.mean(raw / psum(torch.sum(raw, dim=0), model_axis), dim=2)  # (M, C)
        bary_mean = psum(torch.sum(w[:, :, None] * mean, dim=0), model_axis)
        if sigma_mode == "mixture":
            bary_std = torch.sqrt(psum(torch.sum(
                w[:, :, None] * (var + torch.square(mean - bary_mean[None])), dim=0), model_axis))
        else:
            bary_std = psum(torch.sum(w[:, :, None] * torch.sqrt(var), dim=0), model_axis)
    return bary_mean, bary_std, w


def gridded_ensemble_step(
    block: torch.Tensor,  # (M, C, R, T) models x cells realisation stacks
    obs: torch.Tensor,  # (C, R_obs, T) gridded observations
    mask: torch.Tensor,  # (M, C, R)
    model_mask: tp.Optional[torch.Tensor] = None,  # (M,)
    *,
    weight_kind: str = "crps",
    model_axis: tp.Optional[str] = None,
    gp_init: tp.Optional[gp_ops.BatchedGPParams] = None,  # (M, C) leaves
    sigma_mode: str = "w2",
    return_fit: bool = False,
    **emulate_kwargs,
):
    """The whole gridded scenario: emulate -> per-cell weights -> W2
    barycentre, on the device of ``block``.

    The ``M*C`` (model, cell) fits run as one batch
    (``emulate_marginals``; its keyword arguments pass through).
    ``gp_init`` warm-starts each fit from given ``(M, C)`` hyperparameters
    (the coarse-to-fine path, :func:`coarse_warm_start`).

    Returns ``(bary_mean (C, T), bary_std (C, T), weights (M, C))``; with
    ``return_fit=True`` also the fitted ``(M, C)`` hyperparameters and the
    DBA targets ``y_mean, y_var`` ``(M, C, T)``: what
    :func:`refined_gridded_f64` takes.  ``model_axis``: as
    :func:`gridded_tail`'s (:func:`make_sharded_gridded_step`).
    """
    _check_step_options(weight_kind, sigma_mode, model_axis)
    m, c, r, t = block.shape
    if gp_init is not None:
        gp_init = _reshape_params(gp_init, m * c)
    if return_fit:
        emulate_kwargs = dict(emulate_kwargs, return_params=True, return_targets=True)
    with span("step", block, B=m * c, T=t):
        em = emulate_marginals(block.reshape(m * c, r, t), mask.reshape(m * c, r),
                               gp_init=gp_init, **emulate_kwargs)
        mean, var = em[0].reshape(m, c, t), em[1].reshape(m, c, t)
        out = gridded_tail(mean, var, obs, block, mask, model_mask, weight_kind=weight_kind,
                           sigma_mode=sigma_mode, model_axis=model_axis)
    if return_fit:
        params, y_mean, y_var = em[2:]
        return out + (_reshape_params(params, m, c), y_mean.reshape(m, c, t),
                      y_var.reshape(m, c, t))
    return out


def _chunk_bounds(n: int, chunk: tp.Optional[int]):
    """``(lo, hi, pad)`` triples covering ``n`` in equal ``chunk``-sized
    pieces; the ragged last piece is padded by ``pad`` leading elements, so
    every piece has one shape.  ``chunk=None`` (or ``chunk >= n``) is one
    piece; a chunk below 1 raises (the JAX version accepts a negative chunk
    and fails later, opaquely: ROADMAP C4)."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be a positive count or None, got {chunk}")
    if chunk is None or chunk >= n:
        return [(0, n, 0)]
    return [
        (lo, min(lo + chunk, n), chunk - min(lo + chunk, n) + lo)
        for lo in range(0, n, chunk)
    ]


def _tensor(a) -> torch.Tensor:
    """``a`` as a tensor, sharing memory where it can (a read-only numpy
    array, such as a view of another framework's buffer, is copied)."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a)


def _padded(a, lo: int, hi: int, pad: int, axis: int = 0):
    """``a[lo:hi]`` along ``axis``, followed by its first ``pad`` entries."""
    index = [slice(None)] * axis
    piece = a[tuple(index + [slice(lo, hi)])]
    if not pad:
        return piece
    head = a[tuple(index + [slice(0, pad)])]
    return torch.cat([piece, head], dim=axis)


def refine_marginals_f64(
    block,  # (N, R, T) realisation stacks, numpy or tensor
    mask,  # (N, R)
    params: gp_ops.BatchedGPParams,  # (N,) leaves, float32-converged
    targets,  # (y_mean (N, T), y_var (N, T)): the fit's own targets
    *,
    kernel_name: str = "matern32",
    jitter: float = 1e-6,
    device: tp.Union[str, torch.device] = "cuda",
    chunk: tp.Optional[int] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Float64 posterior marginals at float32-converged hyperparameters.

    The marginal-only twin of ``models/gp_dtw.refine_posterior_f64`` for
    the batched and gridded surfaces: the fit stays in float32 and only
    the posterior (Gram, Cholesky, solves) is re-run in float64 on
    ``device`` (the card unless the caller asks for ``"cpu"``; a CUDA
    device without CUDA raises), with the fit's hyperparameters and DBA
    targets unchanged.  On the card the float64 posterior takes the
    Cholesky-solve and triangular-inverse kernels' float64 builds.

    ``chunk`` bounds the float64 working set (the Gram is N T^2 8 bytes):
    the batch runs in equal ``chunk``-sized pieces (ragged tail padded with
    leading rows, sliced off).  Returns ``(mean (N, T), var (N, T))`` as
    float64 tensors on ``device``, the variance including the noise.
    """
    device = resolve_device(device, "refine_marginals_f64")
    del mask  # masked realisations are already folded into the targets
    f64 = torch.float64
    y_mean, y_var = targets
    n = block.shape[0]
    # The features stay in the block's dtype until a chunk is on the device.
    x = _tensor(block).transpose(1, 2)
    y_mean, y_var = _tensor(y_mean), _tensor(y_var)
    ls, var_raw = params.raw_lengthscale.detach(), params.raw_variance.detach()
    means, varis = [], []
    for lo, hi, pad in _chunk_bounds(n, chunk):
        piece = functools.partial(_padded, lo=lo, hi=hi, pad=pad)
        p64 = gp_ops.BatchedGPParams(_to(piece(ls), f64, device), _to(piece(var_raw), f64, device))
        ym, yv = _to(piece(y_mean), f64, device), _to(piece(y_var), f64, device)
        mu, v = gp_ops.posterior_marginals_batch(p64, _to(piece(x), f64, device), ym, yv,
                                                 kernel_name=kernel_name, jitter=jitter)
        means.append(mu[: hi - lo])
        varis.append((v + yv)[: hi - lo])
    return torch.cat(means), torch.cat(varis)


def refined_gridded_f64(
    block,  # (M, C, R, T), numpy or tensor
    obs,  # (C, R_obs, T)
    mask,  # (M, C, R)
    params: gp_ops.BatchedGPParams,  # (M, C) leaves, float32-converged
    targets,  # (y_mean (M, C, T), y_var (M, C, T))
    *,
    model_mask=None,  # (M,)
    weight_kind: str = "crps",
    sigma_mode: str = "w2",
    kernel_name: str = "matern32",
    jitter: float = 1e-6,
    device: tp.Union[str, torch.device] = "cuda",
    cell_chunk: tp.Optional[int] = None,
) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Float64 refinement of the whole gridded step at given (float32-fitted)
    hyperparameters and DBA targets.

    The gridded twin of ``parallel/step.refined_multi_scenario_f64``:
    recomputes the posterior marginals in float64
    (:func:`refine_marginals_f64`) and re-runs the weighting and barycentre
    tail (:func:`gridded_tail`) in float64, on ``device`` (the card unless
    the caller asks for ``"cpu"``).  Every cell is independent, so
    ``cell_chunk`` bounds the float64 working set: the cells run in equal
    pieces (ragged tail padded with leading cells, sliced off).

    Returns float64 numpy ``(bary_mean (C, T), bary_std (C, T),
    weights (M, C))``.
    """
    device = resolve_device(device, "refined_gridded_f64")
    f64 = torch.float64
    m, c, r, t = block.shape
    block, obs, mask = (_tensor(a) for a in (block, obs, mask))
    y_mean, y_var = (_tensor(a) for a in targets)
    ls, var_raw = params.raw_lengthscale.detach(), params.raw_variance.detach()
    mm64 = None if model_mask is None else _to(model_mask, f64, device)
    bms, bss, ws = [], [], []
    for lo, hi, pad in _chunk_bounds(c, cell_chunk):
        cells = functools.partial(_padded, lo=lo, hi=hi, pad=pad, axis=1)
        nc = hi - lo + pad
        mu, var = refine_marginals_f64(
            cells(block).reshape(m * nc, r, t), None,
            gp_ops.BatchedGPParams(cells(ls).reshape(m * nc), cells(var_raw).reshape(m * nc)),
            (cells(y_mean).reshape(m * nc, t), cells(y_var).reshape(m * nc, t)),
            kernel_name=kernel_name, jitter=jitter, device=device,
        )
        with torch.no_grad():
            bm, bs, w = gridded_tail(
                mu.reshape(m, nc, t), var.reshape(m, nc, t),
                _to(_padded(obs, lo, hi, pad), f64, device), _to(cells(block), f64, device),
                _to(cells(mask), f64, device), mm64,
                weight_kind=weight_kind, sigma_mode=sigma_mode,
            )
        bms.append(bm[: hi - lo].cpu())
        bss.append(bs[: hi - lo].cpu())
        ws.append(w[:, : hi - lo].cpu())
    return (torch.cat(bms).numpy(), torch.cat(bss).numpy(), torch.cat(ws, dim=1).numpy())


def coarse_cell_indices(lat: int, lon: int, stride: int) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Strided coarse subset of a row-major ``(lat, lon)`` cell grid.

    Returns ``(coarse, nearest)``: ``coarse`` is the flat cell indices of
    every ``stride``-th row and column; ``nearest[c]`` maps each fine cell to
    the index, within the coarse subset, of its nearest coarse cell.
    """
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    rows = np.arange(0, lat, stride)
    cols = np.arange(0, lon, stride)
    coarse = (rows[:, None] * lon + cols[None, :]).ravel()
    ri = np.clip(np.round(np.arange(lat) / stride).astype(int), 0, len(rows) - 1)
    ci = np.clip(np.round(np.arange(lon) / stride).astype(int), 0, len(cols) - 1)
    nearest = (ri[:, None] * len(cols) + ci[None, :]).ravel()
    return coarse, nearest


def coarse_warm_start(
    block: torch.Tensor,  # (M, C, R, T)
    mask: torch.Tensor,  # (M, C, R)
    lat: int,
    lon: int,
    stride: int,
    *,
    n_optim_nits: int = 500,
    mesh=None,
    cells_axis: str = "cells",
    **emulate_kwargs,
) -> gp_ops.BatchedGPParams:
    """Coarse-to-fine warm start for the gridded experiment.

    Fits every ``stride``-th row and column of the grid (``stride^2``-fold
    fewer cells) from scratch at ``n_optim_nits`` steps, then hands each
    fine cell the converged hyperparameters of its nearest coarse cell;
    neighbouring cells have near-identical optima, so the fine pass
    (``gridded_ensemble_step(..., gp_init=...)``) needs a fraction of the
    scratch steps.  Returns ``(M, C)`` hyperparameters aligned with
    ``block``'s cell axis, on its device (with ``mesh``: on this rank's).
    With ``mesh`` the coarse fit shards its (model x coarse-cell) axis over
    ``cells_axis`` (:func:`coarse_fit_params`).
    """
    m, c, r, t = block.shape
    if c != lat * lon:
        raise ValueError(f"cells {c} != lat*lon {lat * lon}")
    coarse, nearest = coarse_cell_indices(lat, lon, stride)
    sel = torch.as_tensor(coarse, device=block.device)
    cb = block[:, sel].reshape(m * coarse.size, r, t)
    cm = mask[:, sel].reshape(m * coarse.size, r)
    params = coarse_fit_params(cb, cm, n_optim_nits=n_optim_nits, mesh=mesh, cells_axis=cells_axis,
                               **emulate_kwargs)
    near = torch.as_tensor(nearest, device=params.raw_lengthscale.device)
    return gp_ops.BatchedGPParams(
        params.raw_lengthscale.detach().reshape(m, coarse.size)[:, near],
        params.raw_variance.detach().reshape(m, coarse.size)[:, near],
    )


def coarse_fit_params(
    cb: torch.Tensor,  # (N, R, T) stacked coarse-cell realisations
    cm: torch.Tensor,  # (N, R)
    *,
    n_optim_nits: int = 500,
    mesh=None,
    cells_axis: str = "cells",
    **emulate_kwargs,
) -> gp_ops.BatchedGPParams:
    """Scratch-fitted hyperparameters ``(N,)`` of a stack of coarse cells:
    the lower half of :func:`coarse_warm_start`, for callers that build
    their own coarse subsets.

    With ``mesh`` the ``N`` fits are sharded over its ``cells_axis`` (padded
    with copies of the first to a multiple of the axis size, the padding
    dropped) with no collective but one: the fitted hyperparameters are
    gathered, so every rank returns all ``N`` (on its device), as the fine
    pass indexes them by nearest coarse cell.
    """
    if mesh is None:
        _, _, params = emulate_marginals(cb, cm, n_optim_nits=n_optim_nits, return_params=True,
                                         **emulate_kwargs)
        return _reshape_params(params, cb.shape[0])
    device = mesh_device(mesh)
    cb, cm = _tensor_on(cb, device), _tensor_on(cm, device)
    n, n_dev = cb.shape[0], axis_size(mesh, cells_axis)
    reps = -(-n // n_dev) * n_dev - n
    if reps:
        cb = torch.cat([cb, cb[:1].expand(reps, *cb.shape[1:])])
        cm = torch.cat([cm, cm[:1].expand(reps, *cm.shape[1:])])

    def fit(b, m):
        _, _, params = emulate_marginals(b, m, n_optim_nits=n_optim_nits, return_params=True,
                                         **emulate_kwargs)
        both = all_gather(torch.stack(_leaves(params)), cells_axis, dim=1)
        return both[0], both[1]

    p = (cells_axis,)
    ls, var = shard_map(fit, mesh, (p, p), ((), ()))(cb, cm)
    return gp_ops.BatchedGPParams(ls[:n], var[:n])
