"""Perfect-model test harness: leave-one-out validation of the ensembling
framework.

PyTorch counterpart of ``bayesian_ensembling_tpu/validation.py``: each model
in turn becomes the "pseudo truth"; the remaining models are emulated,
weighted against the pseudo observations' past, combined with the ensemble
scheme over the forecast period, and scored (NLL / RMSE / W2 / CRPS) against
the pseudo truth, with a pooled multi-model-mean baseline.  Results go into a
CSV; weight bar charts and projection figures are written per fold.

Two forms of the same test:

  * :meth:`PerfectModelTest.run`, the fold loop through the library API
    (fresh fits per fold on ``device``, the card unless the caller passes
    ``device="cpu"`` among the fit keywords, or prefit posteriors);
  * :func:`batched_pmt` / :meth:`PerfectModelTest.run_batched`, every fold
    of prefit posteriors at once: one function with an explicit leading
    fold axis over tensors on the posteriors' device.

pandas is imported only where a DataFrame or a CSV is made, and matplotlib
only where a figure is drawn.
"""

from __future__ import annotations

import copy
import os
import typing as tp
import warnings

import numpy as np
import torch

from bayesian_ensembling_tpu_torch import metrics
from bayesian_ensembling_tpu_torch.coords import DimArray
from bayesian_ensembling_tpu_torch.data import ModelCollection, Posterior, ProcessModel
from bayesian_ensembling_tpu_torch.ops import linalg_cuda, scoring
from bayesian_ensembling_tpu_torch.ops.distributions import DiagGaussian, FullCovGaussian
from bayesian_ensembling_tpu_torch.ops.wasserstein import (
    batched_gaussian_barycentre,
    gaussian_w2_distance,
    gaussian_w2_distance_diag,
)
from bayesian_ensembling_tpu_torch.schemes import Barycentre, MultiModelMean
from bayesian_ensembling_tpu_torch.weights import ModelSimilarityWeight

__all__ = ["PerfectModelTest", "batched_pmt", "load_model_collection"]


def load_model_collection(
    path: str, device: tp.Union[str, torch.device] = "cuda"
) -> ModelCollection:
    """Load a checkpointed :class:`ModelCollection` (an npz archive written
    by either package's ``ModelCollection.save``); fitted posteriors'
    moments are placed on ``device``."""
    return ModelCollection.load(path, device=device)


#: library weighter class name -> batched_pmt weight_kind
BATCHED_WEIGHT_KINDS = {
    "LogLikelihoodWeight": "loglik",
    "InverseSquareWeight": "inverse_square",
    "UniformWeight": "uniform",
    "KernelSteinDiscrepancyWeight": "ksd",
    "ContinuousRankedProbabilityScoreWeight": "crps",
}

_CHOL_JITTER = 1e-10  # FullCovGaussian.chol's default
_FIXED_POINT_CAP = 200  # the compat fixed point's iteration cap

#: the eight columns of a fold's scores, in order
_METRIC_NAMES = ("nll_bary", "rmse_bary", "w2_bary", "crps_bary",
                 "nll_mmm", "rmse_mmm", "w2_mmm", "crps_mmm")


def _masked_mean_r(x: torch.Tensor, w_r: torch.Tensor) -> torch.Tensor:
    """Masked mean over the realisation axis: ``x (..., R, T)`` with
    ``w_r (..., R)`` floats gives ``(..., T)``."""
    total = torch.sum(x * w_r[..., None], dim=-2)
    return total / torch.clamp(torch.sum(w_r, dim=-1), min=1.0)[..., None]


def _pmt_folds(
    hist_mean, hist_var, fore_mean, fore_var, fore_cov, hist_block, hist_w, fore_block,
    fore_w, ll_table, sim_pair, real_mask, n_real: int, *, weight_kind: str,
    sigma_mode: str, w2_diag: bool,
):
    """Every leave-one-out fold at once, fold axis first.

    Args (``M`` the possibly padded model count, which is also the fold
    count ``F``):
      hist_mean / hist_var: ``(M, T_h)`` posterior moments (padded models:
        0 / 1).
      fore_mean / fore_var: ``(M, T_s)``.
      fore_cov: ``(M, T_s, T_s)`` (padded: identity), or with ``w2_diag``
        the ``(M, T_s)`` variances (padded: ones).
      hist_block / fore_block: ``(M, R, T)`` raw realisations, zero padded;
        hist_w / fore_w: ``(M, R)`` realisation masks as floats.
      ll_table: ``(M_model, M_fold, T_h)`` mean log-likelihoods (loglik only).
      sim_pair: None or ``(diag (M, M), full (M, M), use_full (M,))`` W2.
      real_mask: ``(M,)`` 1 for real models, 0 for padding.
      n_real: the number of real models.

    Returns ``(metrics (F, 8), w (F, M), bary_mu, bary_sigma, mmm_mu,
    mmm_var (F, T_s), n_fp_bad (F,))``; ``n_fp_bad`` counts each fold's
    points that hit the fixed point's cap (compat mode only, else zeros).
    """
    m, t_s = fore_mean.shape
    # Padded fold lanes (i >= n_real) recompute the last real fold: always
    # finite lanes, sliced off by the caller.
    fold = torch.clamp(torch.arange(m, device=hist_mean.device), max=n_real - 1)
    mmask = (torch.arange(m, device=hist_mean.device)[None, :] != fold[:, None]).to(
        hist_mean.dtype) * real_mask[None, :]  # (F, M)
    obs, ow = hist_block[fold], hist_w[fold]  # (F, R, T_h), (F, R)

    if weight_kind == "loglik":
        # softmax over the REMAINING models == the reduced-collection
        # softmax of the library's LogLikelihoodWeight.
        ll = ll_table[:, fold].transpose(0, 1)  # (F, M_model, T_h)
        weights_t = torch.softmax(
            torch.where(mmask[..., None] > 0, ll, torch.full_like(ll, -torch.inf)), dim=1)
    else:
        if weight_kind == "uniform":
            raw = torch.ones_like(hist_mean).expand(m, -1, -1)
        elif weight_kind == "inverse_square":
            # Realisation means (padded models give 0/1 = 0, masked below).
            hist_real_mu = _masked_mean_r(hist_block, hist_w)  # (M, T_h)
            sq = torch.square(hist_real_mu[None] - _masked_mean_r(obs, ow)[:, None, :])
            # The held-out model's distance to its own obs is 0: guard the
            # inversion (its row is masked out below anyway).
            raw = 1.0 / torch.where(mmask[..., None] > 0, sq, torch.ones_like(sq))
        elif weight_kind == "crps":
            c = scoring.gaussian_crps(obs[:, None], hist_mean[None, :, None, :],
                                      torch.sqrt(hist_var)[None, :, None, :])  # (F, M, R, T_h)
            raw = 1.0 / _masked_mean_r(c, ow[:, None, :])
        elif weight_kind == "ksd":
            x = obs.transpose(1, 2)[:, None]  # (F, 1, T_h, R)
            sigma = torch.sqrt(hist_var)[None, :, :, None]
            grads = -(x - hist_mean[None, :, :, None]) / torch.square(sigma)
            k0 = scoring.imq_k0_matrix(x, grads)  # (F, M, T_h, R, R)
            pair_w = ow[:, :, None] * ow[:, None, :]  # (F, R, R)
            total = torch.sum(k0 * pair_w[:, None, None], dim=(-2, -1))
            n = torch.clamp(torch.sum(ow, dim=-1), min=1.0)[:, None, None]
            raw = 1.0 / (torch.sqrt(total) / n)
        else:
            raise ValueError(f"unknown weight_kind {weight_kind!r}")
        raw = raw * mmask[..., None]
        weights_t = raw / torch.sum(raw, dim=1, keepdim=True)
    w = torch.mean(weights_t, dim=2)  # (F, M): time-mean, one weight per model

    if sim_pair is not None:
        # Reduced-collection similarity vector: mean over the remaining
        # columns, normalised, multiplied in, renormalised.  The library's
        # ModelSimilarityWeight picks full-cov vs diag W2 on the REDUCED
        # collection, so the choice is per fold.
        pair_diag, pair_full, use_full = sim_pair
        pair = torch.where(use_full[fold][:, None, None], pair_full[None], pair_diag[None])
        red = pair * mmask[:, None, :]
        sim = torch.sum(red, dim=2) / torch.clamp(torch.sum(mmask, dim=1), min=1.0)[:, None]
        sim = sim * mmask
        sim = sim / torch.sum(sim, dim=1, keepdim=True)
        w = w * sim
        w = w / torch.sum(w, dim=1, keepdim=True)

    means = fore_mean.expand(m, -1, -1)
    stds = torch.sqrt(fore_var).expand(m, -1, -1)
    if sigma_mode == "compat":
        bary_mu, bary_sigma, n_it = batched_gaussian_barycentre(
            means, stds, w[..., None].expand(-1, -1, t_s).contiguous(), sigma_mode="compat")
        n_fp_bad = torch.sum(n_it > _FIXED_POINT_CAP, dim=1)
    else:
        bary_mu, bary_sigma = batched_gaussian_barycentre(means, stds, w[..., None],
                                                          sigma_mode=sigma_mode)
        n_fp_bad = torch.zeros(m, dtype=torch.int64, device=w.device)

    truth, tw = fore_block[fold], fore_w[fold]  # (F, R, T_s), (F, R)
    n_truth = torch.clamp(torch.sum(tw, dim=1), min=1.0)  # (F,)

    def nll_of(mu, var):
        ll = scoring.diag_log_likelihood(mu[:, None], var[:, None], truth)  # (F, R, T_s)
        return -torch.sum(ll * tw[..., None], dim=(1, 2)) / (n_truth * t_s)

    def rmse_of(mu):
        se = torch.square(mu[:, None] - truth)
        return torch.mean(torch.sqrt(torch.sum(se * tw[..., None], dim=1) / n_truth[:, None]),
                          dim=1)

    def crps_of(mu, sigma):
        # metrics.crps semantics: mean over valid realisations per point
        # (masked), then mean over time.
        c = scoring.gaussian_crps(truth, mu[:, None], sigma[:, None])
        return torch.sum(c * tw[..., None], dim=(1, 2)) / (n_truth * t_s)

    def w2_of(mu, var):
        if w2_diag:
            # All forecast posteriors are diagonal: the closed-form diagonal
            # W2 equals the dense one without the two eigendecompositions.
            return gaussian_w2_distance_diag(mu, var, fore_mean[fold], fore_cov[fold])
        return gaussian_w2_distance(mu, torch.diag_embed(var), fore_mean[fold], fore_cov[fold])

    bary_var = torch.square(bary_sigma)
    # Pooled multi-model-mean baseline over the remaining models
    # (population variance, schemes.MultiModelMean semantics).
    pw = fore_w[None] * mmask[..., None]  # (F, M, R)
    cnt = torch.clamp(torch.sum(pw, dim=(1, 2)), min=1.0)[:, None]
    mmm_mu = torch.einsum("mrt,fmr->ft", fore_block, pw) / cnt
    mmm_var = torch.einsum("mrt,fmr->ft", torch.square(fore_block), pw) / cnt - torch.square(mmm_mu)
    mmm_var = torch.clamp(mmm_var, min=1e-12)
    scores = torch.stack([
        nll_of(bary_mu, bary_var), rmse_of(bary_mu), w2_of(bary_mu, bary_var),
        crps_of(bary_mu, bary_sigma),
        nll_of(mmm_mu, mmm_var), rmse_of(mmm_mu), w2_of(mmm_mu, mmm_var),
        crps_of(mmm_mu, torch.sqrt(mmm_var)),
    ], dim=1)
    return scores, w, bary_mu, bary_sigma, mmm_mu, mmm_var, n_fp_bad


def _loglik_table(hindcast_models, hist_mean, hist_var, hist_block, hist_w):
    """``(M_model, M_fold, T_h)`` mean log-likelihood of every fold's
    pseudo observations under every model, each model on its OWN branch:
    the full-covariance members together (one Cholesky of their stacked
    covariances with ``FullCovGaussian.chol``'s jitter, then the
    constant-vector scores: two forward-only vector solves), the diagonal
    members in closed form.  Mixed collections match the library path,
    which dispatches per model."""
    gaussians = [pm.distribution.gaussian for pm in hindcast_models]
    full = [i for i, g in enumerate(gaussians) if isinstance(g, FullCovGaussian)]
    diag = [i for i in range(len(gaussians)) if i not in full]
    n_fold, n_r, t_h = hist_block.shape
    table = torch.empty((len(gaussians), n_fold, t_h), dtype=hist_mean.dtype,
                        device=hist_mean.device)
    if full:
        cov = torch.stack([gaussians[i].cov.to(hist_mean.dtype) for i in full])
        eye = torch.eye(t_h, dtype=cov.dtype, device=cov.device)
        chol = linalg_cuda.chol_routed((cov + _CHOL_JITTER * eye).contiguous())
        ll = scoring.fullcov_constant_vector_log_likelihood(
            hist_mean[full], chol, hist_block.reshape(n_fold * n_r, t_h))
        table[full] = _masked_mean_r(ll.reshape(len(full), n_fold, n_r, t_h), hist_w[None])
    if diag:
        ll = scoring.diag_log_likelihood(hist_mean[diag][:, None, None, :],
                                         hist_var[diag][:, None, None, :], hist_block[None])
        table[diag] = _masked_mean_r(ll, hist_w[None])
    return table


def _pairwise_sim(hindcast_models, hist_mean, hist_var):
    """The ``include_sim`` pair: pairwise W2 over the hindcast posteriors,
    diagonal and full covariance, computed once, and the per-fold selector
    ``use_full[i]`` (every model other than i is full-covariance)."""
    m = len(hindcast_models)
    full_flags = np.array([isinstance(pm.distribution.gaussian, FullCovGaussian)
                           for pm in hindcast_models])
    use_full = np.array([full_flags[np.arange(m) != i].all() for i in range(m)])
    sim_diag = gaussian_w2_distance_diag(hist_mean[:, None], hist_var[:, None],
                                         hist_mean[None], hist_var[None])
    if use_full.any():
        # Diag members are diag-embedded; their rows and columns are never
        # selected on a use_full fold (the fold mask excludes them).
        covs = torch.stack([
            pm.distribution.gaussian.cov.to(hist_mean.dtype)
            if isinstance(pm.distribution.gaussian, FullCovGaussian) else torch.diag(v)
            for pm, v in zip(hindcast_models, hist_var)
        ])
        sim_full = gaussian_w2_distance(hist_mean[:, None], covs[:, None], hist_mean[None],
                                        covs[None])
    else:
        sim_full = sim_diag
    return sim_diag, sim_full, torch.as_tensor(use_full, device=hist_mean.device)


def _pad(a: torch.Tensor, axis: int, n: int, value: float = 0.0) -> torch.Tensor:
    grow = n - a.shape[axis]
    if grow == 0:
        return a
    shape = list(a.shape)
    shape[axis] = grow
    return torch.cat([a, torch.full(shape, value, dtype=a.dtype, device=a.device)], dim=axis)


def batched_pmt(
    hindcast_models: ModelCollection,
    forecast_models: ModelCollection,
    weight_kind: str,
    *,
    compat_fixed_point: bool = False,
    sigma_mode: str = "w2",
    include_sim: bool = False,
    pad_shape: tp.Optional[tp.Tuple[int, int]] = None,
    return_details: bool = False,
):
    """ALL leave-one-out folds of the perfect-model test at once.

    With prefit posteriors every fold is pure tensor arithmetic, so the
    folds run together along a leading fold axis with a model mask, on the
    device and in the dtype of the first hindcast posterior.  Matches
    ``PerfectModelTest.run(use_prefit_models=True)`` for the five campaign
    weighters (``BATCHED_WEIGHT_KINDS``), including the full-covariance
    constant-vector log-likelihood branch and the reference-faithful
    fixed-point barycentre under ``compat_fixed_point``.

    Args:
      hindcast_models / forecast_models: PREFIT collections (posteriors set).
      weight_kind: one of crps / loglik / ksd / inverse_square / uniform.
      pad_shape: optional ``(pad_m, pad_r)`` shape bucket: the model and
        realisation axes are zero-padded (with masks) up to these sizes, as
        the campaign CLI passes them; padded fold lanes recompute the last
        real fold and are sliced off.  The result equals the unpadded one.
      return_details: also return the per-fold combination products as a
        dict (``weights`` (M, M) fold x model time-mean weights,
        ``bary_mean``/``bary_sigma``/``mmm_mean``/``mmm_var`` (M, T_s)) for
        the per-fold figures.

    Returns:
      ``(n_models, 8)`` numpy array, columns ``[nll_bary, rmse_bary,
      w2_bary, crps_bary, nll_mmm, rmse_mmm, w2_mmm, crps_mmm]`` in
      leave-one-out order (fold i = model i as pseudo truth); with
      ``return_details`` a ``(metrics, details)`` tuple.
    """
    m = len(hindcast_models)
    if m < 2:
        # With the masked reductions a single model would produce silent
        # 0/0 = NaN weights instead of the loop path's loud failure.
        raise ValueError(
            f"batched_pmt needs at least 2 models (got {m}): leave-one-out "
            "folds weight the remaining models against the held-out one"
        )
    first = hindcast_models[0].distribution.gaussian.mean
    device, dtype = first.device, first.dtype

    def stack(collection, attr):
        return torch.stack([getattr(pm.distribution.gaussian, attr).to(device, dtype)
                            for pm in collection])

    hist_mean, hist_var = stack(hindcast_models, "mean"), stack(hindcast_models, "variance")
    fore_mean, fore_var = stack(forecast_models, "mean"), stack(forecast_models, "variance")
    # Raw realisations at the POSTERIOR dtype: a float32 stack would
    # truncate the float64 path's data.
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def blocks(collection):
        block, rmask = collection.padded_stack(dtype=np_dtype)
        return (torch.as_tensor(block, device=device),
                torch.as_tensor(rmask, device=device).to(dtype))

    hist_block, hist_w = blocks(hindcast_models)
    fore_block, fore_w = blocks(forecast_models)
    t_s = fore_mean.shape[1]
    # With all-diagonal forecast posteriors the fold W2 is the closed-form
    # diagonal one: no (M, T_s, T_s) embedding, no eigendecompositions.
    w2_diag = not any(isinstance(pm.distribution.gaussian, FullCovGaussian)
                      for pm in forecast_models)
    if w2_diag:
        fore_cov = fore_var
    else:
        fore_cov = torch.stack([
            pm.distribution.gaussian.cov.to(device, dtype)
            if isinstance(pm.distribution.gaussian, FullCovGaussian) else torch.diag(v)
            for pm, v in zip(forecast_models, fore_var)
        ])

    sim_pair = None
    if include_sim:
        if m < 3:
            # One remaining model has no one to be similar to: the loop
            # path fails inside ModelSimilarityWeight; here it would be a
            # silent 0/0 = NaN.
            raise ValueError(
                f"include_sim needs at least 3 models (got {m}): each "
                "leave-one-out fold computes similarity over the remaining "
                "models, and one model has no one to be similar to"
            )
        sim_pair = _pairwise_sim(hindcast_models, hist_mean, hist_var)

    if pad_shape is not None:
        pad_m, pad_r = pad_shape
        r_have = max(hist_block.shape[1], fore_block.shape[1])
        if pad_m < m or pad_r < r_have:
            raise ValueError(f"pad_shape {pad_shape} smaller than data (M={m}, R={r_have})")
        hist_mean = _pad(hist_mean, 0, pad_m)
        hist_var = _pad(hist_var, 0, pad_m, 1.0)  # benign sigma for padding
        fore_mean = _pad(fore_mean, 0, pad_m)
        fore_var = _pad(fore_var, 0, pad_m, 1.0)
        if w2_diag:
            fore_cov = _pad(fore_cov, 0, pad_m, 1.0)  # benign unit variances
        else:
            eye = torch.eye(t_s, dtype=dtype, device=device)
            fore_cov = torch.cat([fore_cov, eye.expand(pad_m - m, t_s, t_s)], dim=0)
        hist_block = _pad(_pad(hist_block, 1, pad_r), 0, pad_m)
        fore_block = _pad(_pad(fore_block, 1, pad_r), 0, pad_m)
        hist_w = _pad(_pad(hist_w, 1, pad_r), 0, pad_m)
        fore_w = _pad(_pad(fore_w, 1, pad_r), 0, pad_m)
        if sim_pair is not None:
            sd, sf, uf = sim_pair
            sim_pair = (_pad(_pad(sd, 0, pad_m), 1, pad_m), _pad(_pad(sf, 0, pad_m), 1, pad_m),
                        _pad(uf, 0, pad_m, False))  # padded folds: use_full False
    m_pad = hist_mean.shape[0]
    real_mask = (torch.arange(m_pad, device=device) < m).to(dtype)

    ll_table = None
    if weight_kind == "loglik":
        ll_table = _pad(_loglik_table(hindcast_models, hist_mean[:m], hist_var[:m], hist_block,
                                      hist_w), 0, m_pad)

    if compat_fixed_point:
        sigma_mode = "compat"
    scores, w, bary_mu, bary_sigma, mmm_mu, mmm_var, n_fp_bad = _pmt_folds(
        hist_mean, hist_var, fore_mean, fore_var, fore_cov, hist_block, hist_w, fore_block,
        fore_w, ll_table, sim_pair, real_mask, m, weight_kind=weight_kind,
        sigma_mode=sigma_mode, w2_diag=w2_diag,
    )
    if sigma_mode == "compat":
        # The loop path's schemes.Barycentre warns per fold; same diagnostic.
        n_bad = int(torch.sum(n_fp_bad[:m]))
        if n_bad:
            warnings.warn(
                f"Barycentre not converged for {n_bad} point(s) across folds "
                "(fixed-point cap reached)"
            )

    def host(x):
        return x[:m].detach().cpu().numpy()

    if not return_details:
        return host(scores)
    details = {
        "weights": host(w)[:, :m],
        "bary_mean": host(bary_mu),
        "bary_sigma": host(bary_sigma),
        "mmm_mean": host(mmm_mu),
        "mmm_var": host(mmm_var),
    }
    return host(scores), details


class PerfectModelTest:
    """Leave-one-out ensembling validation."""

    def __init__(
        self,
        hindcast_models: ModelCollection,
        forecast_models: ModelCollection,
        emulate_method: tp.Callable,
        weight_method: tp.Callable,
        ensemble_method: tp.Callable,
        ssp: str,
        include_sim: bool = False,
        save_dir: tp.Optional[str] = None,
        scheme_kwargs: tp.Optional[dict] = None,
    ) -> None:
        if hindcast_models.model_names != forecast_models.model_names:
            raise ValueError("hindcast and forecast collections must match")
        self.hindcast_models = hindcast_models
        self.forecast_models = forecast_models
        self.emulate_method = emulate_method
        self.weight_method = weight_method
        self.ensemble_method = ensemble_method
        self.ssp = ssp
        self.include_sim = include_sim
        self.save_dir = save_dir
        # Extra kwargs for the ensemble scheme call, e.g.
        # {"compat_fixed_point": True} to validate with the reference's
        # fixed-point barycentre.
        self.scheme_kwargs = scheme_kwargs or {}
        if save_dir:
            self.fig_dir = os.path.join(save_dir, "figs")
            self.csv_dir = os.path.join(save_dir, "csvs")
            for d in (
                os.path.join(self.fig_dir, "weights"),
                os.path.join(self.fig_dir, "projs"),
                self.csv_dir,
            ):
                os.makedirs(d, exist_ok=True)

    # ------------------------------------------------------------------ core
    def _run_single_test(
        self,
        hindcast: ModelCollection,
        forecast: ModelCollection,
        pseudo_past: ProcessModel,
        pseudo_future: ProcessModel,
        n_optim_nits: int = 1000,
        use_prefit_models: bool = False,
        **fit_kwargs,
    ):
        if not use_prefit_models:
            hindcast.fit(self.emulate_method(), n_optim_nits=n_optim_nits, **fit_kwargs)
            forecast.fit(self.emulate_method(), n_optim_nits=n_optim_nits, **fit_kwargs)
            pseudo_future.distribution = self.emulate_method().fit(
                pseudo_future, n_optim_nits=n_optim_nits, **fit_kwargs
            )

        weight_fn = self.weight_method()
        weights = weight_fn(hindcast, pseudo_past)
        mean_weights = weights.mean("time") if "time" in weights.dims else weights
        if self.include_sim:
            sim = ModelSimilarityWeight()(hindcast, mode="single")
            total = mean_weights.values * np.asarray(sim.values).ravel()
            total = total / total.sum()
        else:
            total = mean_weights.values

        if self.save_dir:
            self._plot_weights(forecast.model_names, total, weight_fn.name, pseudo_future.name)

        w_fore = np.broadcast_to(total[:, None], (len(forecast), len(forecast.time)))
        w_da = DimArray(np.ascontiguousarray(w_fore), ("model", "time"), {"time": forecast.time})
        bary = self.ensemble_method()(forecast, w_da, **self.scheme_kwargs)

        obs_vals = pseudo_future.data.values
        nll_b = metrics.nll(bary, obs_vals)
        rmse_b = metrics.rmse(bary, obs_vals)
        w2_b = metrics.w2_between_posteriors(bary, pseudo_future.distribution)
        crps_b = metrics.crps(bary, obs_vals)

        mmm = MultiModelMean()(forecast)
        nll_m = metrics.nll(mmm, obs_vals)
        rmse_m = metrics.rmse(mmm, obs_vals)
        w2_m = metrics.w2_between_posteriors(mmm, pseudo_future.distribution)
        crps_m = metrics.crps(mmm, obs_vals)

        if self.save_dir:
            self._plot_projection(bary, mmm, pseudo_future, weight_fn.name)

        return nll_b, rmse_b, w2_b, crps_b, nll_m, rmse_m, w2_m, crps_m

    def _fold_scores(
        self, n_optim_nits: int = 1000, use_prefit_models: bool = False, **fit_kwargs
    ) -> tp.Tuple[tp.List[str], np.ndarray]:
        """The fold loop: the pseudo-truth names and an ``(M, 8)`` array of
        scores (columns as ``batched_pmt``'s).  Each fold works on shallow
        copies of the caller's models, so the caller's collections keep no
        posterior from a fresh fit."""
        names, rows = [], []
        for i in range(len(self.hindcast_models)):
            hind = [copy.copy(m) for m in self.hindcast_models]
            fore = [copy.copy(m) for m in self.forecast_models]
            pseudo_past = hind.pop(i)
            pseudo_future = fore.pop(i)
            rows.append(self._run_single_test(
                ModelCollection(hind), ModelCollection(fore), pseudo_past, pseudo_future,
                n_optim_nits=n_optim_nits, use_prefit_models=use_prefit_models, **fit_kwargs,
            ))
            names.append(pseudo_past.name)
        return names, np.asarray(rows, dtype=np.float64)

    def _frame(self, names, scores: np.ndarray, wname: str):
        import pandas as pd

        columns = [f"{c}_{wname}" if c.endswith("_bary") else c for c in _METRIC_NAMES]
        df = pd.DataFrame(scores, columns=columns)
        df.insert(0, "model as pseudo obs", list(names))
        return df

    def run(self, n_optim_nits: int = 1000, use_prefit_models: bool = False, **fit_kwargs):
        """Leave-one-out over every model; returns a pandas DataFrame and
        (when save_dir is set) writes the CSV.

        Extra ``fit_kwargs`` (``device``, ``fit_chunk_steps``,
        ``time_stride`` / ``fine_steps``, ...) are forwarded to every
        per-fold emulator fit; fresh fits run on the card unless they
        include ``device="cpu"``."""
        wname = self.weight_method().name
        names, scores = self._fold_scores(n_optim_nits, use_prefit_models, **fit_kwargs)
        df = self._frame(names, scores, wname)
        if self.save_dir:
            self._save_csv(df, wname)
        return df

    def _weight_suffix(self, wname: str) -> str:
        """One naming scheme for every result artifact (CSVs + figures)."""
        return f"{wname}_plus_sim" if self.include_sim else wname

    def _save_csv(self, df, wname: str) -> None:
        path = os.path.join(
            self.csv_dir,
            f"perfect_model_test_results_{self._weight_suffix(wname)}_{self.ssp}.csv",
        )
        df.to_csv(path)
        print(f"Saved results to {path}")

    def run_batched(self, pad_shape: tp.Optional[tp.Tuple[int, int]] = None,
                    figures: bool = False):
        """All leave-one-out folds at once (``batched_pmt``).

        Requires prefit collections (posteriors set), the Barycentre scheme,
        and a weighter in ``BATCHED_WEIGHT_KINDS``; produces the same
        DataFrame as ``run(use_prefit_models=True)``, including the
        ``include_sim`` similarity multiplier (figures opt-in via
        ``figures=True``, drawn from the batched function's own per-fold
        products).  ``pad_shape=(pad_m, pad_r)`` pads the model and
        realisation axes (see ``batched_pmt``).
        """
        if figures and not self.save_dir:
            raise ValueError(
                "run_batched(figures=True) writes figures under save_dir; "
                "construct PerfectModelTest with save_dir set"
            )
        wname = self.weight_method().name
        kind = BATCHED_WEIGHT_KINDS.get(wname)
        if kind is None:
            raise ValueError(
                f"{wname} has no batched scoring path; use run() "
                f"(supported: {sorted(BATCHED_WEIGHT_KINDS)})"
            )
        if not (isinstance(self.ensemble_method, type)
                and issubclass(self.ensemble_method, Barycentre)):
            name = getattr(self.ensemble_method, "__name__", repr(self.ensemble_method))
            raise ValueError(f"run_batched computes the Barycentre combine; {name} needs run()")
        unfitted = [
            pm.name
            for mc in (self.hindcast_models, self.forecast_models)
            for pm in mc
            if pm.distribution is None
        ]
        if unfitted:
            raise ValueError(
                f"run_batched needs PREFIT collections; missing posteriors "
                f"for {sorted(set(unfitted))}"
            )
        out, details = batched_pmt(
            self.hindcast_models,
            self.forecast_models,
            kind,
            compat_fixed_point=bool(self.scheme_kwargs.get("compat_fixed_point", False)),
            sigma_mode=self.scheme_kwargs.get("sigma_mode", "w2"),
            include_sim=self.include_sim,
            pad_shape=pad_shape,
            return_details=True,
        )
        df = self._frame(self.hindcast_models.model_names, out, wname)
        if self.save_dir:
            self._save_csv(df, wname)
            if figures:
                self._plot_batched_folds(details, wname)
        return df

    def _plot_batched_folds(self, details, wname):
        """The per-fold weight bar chart and projection figure, drawn from
        the batched function's per-fold combination products."""
        names = list(self.forecast_models.model_names)
        template = self.forecast_models[0].blank_template()
        for i, pseudo_name in enumerate(names):
            others = [j for j in range(len(names)) if j != i]
            self._plot_weights([names[j] for j in others], details["weights"][i, others],
                               wname, pseudo_name)
            bary = Posterior(
                gaussian=DiagGaussian(mean=torch.as_tensor(details["bary_mean"][i]),
                                      var=torch.as_tensor(details["bary_sigma"][i] ** 2)),
                template=template,
            )
            mmm = Posterior(
                gaussian=DiagGaussian(mean=torch.as_tensor(details["mmm_mean"][i]),
                                      var=torch.as_tensor(details["mmm_var"][i])),
                template=template,
            )
            self._plot_projection(bary, mmm, self.forecast_models[i], wname)

    # --------------------------------------------------------------- figures
    def _plot_weights(self, model_names, total, wname, pseudo_name):
        from bayesian_ensembling_tpu_torch.plotters import pyplot

        plt = pyplot()
        plt.figure()
        plt.bar(list(model_names), np.asarray(total))
        plt.ylabel("Weights")
        plt.xticks(rotation="vertical")
        suffix = self._weight_suffix(wname)
        path = os.path.join(
            self.fig_dir, "weights", f"{suffix}_with_{pseudo_name}_as_pseudo_truth_{self.ssp}.png"
        )
        plt.savefig(path, bbox_inches="tight")
        plt.close()

    def _plot_projection(self, bary, mmm, pseudo_future, wname):
        from bayesian_ensembling_tpu_torch.plotters import cmap, plot_posterior_temporal, pyplot

        plt = pyplot()
        fig, ax = plt.subplots(figsize=(6.5, 4))
        plot_posterior_temporal(bary, ax=ax, color=cmap()[0], label="Barycentre", n_sigma=(2,))
        if pseudo_future.distribution is not None:
            plot_posterior_temporal(pseudo_future.distribution, ax=ax, color=cmap()[1],
                                    label="True model", n_sigma=(2,))
        plot_posterior_temporal(mmm, ax=ax, color=cmap()[2], label="MMM", n_sigma=(2,))
        ax.set_xlabel("Time")
        ax.set_ylabel("Temperature anomaly (degC)\nrelative to 1961-1990")
        ax.legend()
        suffix = self._weight_suffix(wname)
        path = os.path.join(
            self.fig_dir, "projs", f"{pseudo_future.name}_as_pseudo_truth_{suffix}_{self.ssp}.png"
        )
        fig.savefig(path)
        plt.close(fig)
