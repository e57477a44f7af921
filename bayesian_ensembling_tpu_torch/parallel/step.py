"""The ensemble step: DBA -> GP fit -> posterior marginals -> weights ->
W2 barycentre.

PyTorch counterpart of ``bayesian_ensembling_tpu/parallel/step.py``,
unsharded.  :func:`ensemble_multi_scenario_step` merges the (scenario,
model) axes so that each collection (historical, SSP) is emulated in one
batch of ``S*M`` models; the per-scenario weighting and barycentre tail is
elementwise work.  :func:`refined_multi_scenario_f64` re-runs the posterior
and the tail in float64 at given hyperparameters.  The model-sharded step
(``model_axis``) raises ``NotImplementedError`` naming ROADMAP.md item A10.
"""

from __future__ import annotations

import functools
import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import not_ported
from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
from bayesian_ensembling_tpu_torch.ops import scoring

__all__ = [
    "WEIGHT_KINDS",
    "chunked_marginals",
    "emulate_marginals",
    "fused_raw_weights",
    "ensemble_scenario_step",
    "ensemble_multi_scenario_step",
    "multi_scenario_tail",
    "pad_models",
    "refined_multi_scenario_f64",
]

_SIGMA_MODES = ("w2", "mixture")

# Every reference weighter.  ``similarity`` is the reference's temporal mode
# (one weight per model and timestep), ``similarity_single`` its single mode
# (one whole-series weight per model, broadcast over time).
WEIGHT_KINDS = (
    "crps",
    "loglik",
    "ksd",
    "inverse_square",
    "uniform",
    "similarity",
    "similarity_single",
)


def _recip(score: torch.Tensor) -> torch.Tensor:
    """1 / score, the score floored at sqrt(tiny): an exact zero would give
    inf and inf/inf = NaN in the sum-to-one normalisation, while 1/tiny
    would overflow the sum over a few floored models."""
    floor = float(np.sqrt(torch.finfo(score.dtype).tiny))
    return 1.0 / torch.clamp(score, min=floor)


def fused_raw_weights(
    weight_kind: str,
    hist_mean: torch.Tensor,  # (M, T) posterior marginal means
    hist_var: torch.Tensor,  # (M, T) marginal variances incl. noise
    obs: torch.Tensor,  # (R_obs, T)
    hist_block: tp.Optional[torch.Tensor] = None,  # (M, R, T) raw realisations
    hist_mask: tp.Optional[torch.Tensor] = None,  # (M, R)
    model_mask: tp.Optional[torch.Tensor] = None,  # (M,) 1 = real, 0 = padded
    model_axis: tp.Optional[str] = None,
) -> torch.Tensor:
    """Raw (un-normalised) weight scores ``(M, T)`` of one scenario:

      * ``crps``: 1 / mean closed-form Gaussian CRPS against the observations;
      * ``loglik``: exp(mean observation log-likelihood), shifted by its max
        over the real models (``model_mask``) so that it cannot underflow;
      * ``ksd``: 1 / IMQ kernel Stein discrepancy (the score's scale is the
        marginal std);
      * ``inverse_square``: (realisation mean - observation mean)^-2, from
        ``hist_block`` and ``hist_mask``;
      * ``uniform``: ones;
      * ``similarity``: mean over the real models j of the per-timestep W2
        dissimilarity |dmu| + dsigma^2;
      * ``similarity_single``: the same with one whole-series W2 per pair,
        ||dmu||_2 + sum_t dsigma^2, broadcast over time.
    """
    if model_axis is not None:
        raise not_ported("model_axis (model-sharded step)", "A10")
    if weight_kind == "crps":
        return _recip(scoring.mean_gaussian_crps(hist_mean, torch.sqrt(hist_var), obs))
    if weight_kind == "loglik":
        ll = scoring.diag_log_likelihood(hist_mean[:, None, :], hist_var[:, None, :], obs)
        ll = torch.mean(ll, dim=1)
        if model_mask is not None:
            ll = torch.where(model_mask[:, None] > 0, ll, -float("inf"))
        return torch.exp(ll - torch.amax(ll, dim=0, keepdim=True))
    if weight_kind == "ksd":
        return _recip(scoring.batched_imq_ksd(hist_mean, torch.sqrt(hist_var), obs))
    if weight_kind == "inverse_square":
        if hist_block is None or hist_mask is None:
            raise ValueError("inverse_square needs the raw realisation block")
        w = hist_mask.to(hist_block.dtype)
        n = torch.clamp(torch.sum(w, dim=1), min=1.0)
        mu = torch.einsum("mrt,mr->mt", hist_block, w) / n[:, None]
        return _recip(torch.square(mu - torch.mean(obs, dim=0)[None, :]))
    if weight_kind == "uniform":
        return torch.ones_like(hist_mean)
    if weight_kind in ("similarity", "similarity_single"):
        std = torch.sqrt(hist_var)
        d_mu = hist_mean[:, None, :] - hist_mean[None, :, :]  # (M, M, T)
        d_sd = std[:, None, :] - std[None, :, :]
        if weight_kind == "similarity_single":
            pair = torch.sqrt(torch.sum(torch.square(d_mu), dim=-1)) + torch.sum(
                torch.square(d_sd), dim=-1
            )  # (M, M)
            if model_mask is not None:
                valid = model_mask.to(pair.dtype)
                vec = pair @ valid / torch.clamp(torch.sum(valid), min=1.0)
            else:
                vec = torch.mean(pair, dim=1)
            return vec[:, None].expand_as(hist_mean)
        pair = torch.abs(d_mu) + torch.square(d_sd)
        if model_mask is not None:
            valid = model_mask.to(pair.dtype)
            return torch.einsum("ijt,j->it", pair, valid) / torch.clamp(torch.sum(valid), min=1.0)
        return torch.mean(pair, dim=1)
    raise ValueError(f"unknown weight_kind {weight_kind!r}; one of {WEIGHT_KINDS}")


def emulate_marginals(
    block: torch.Tensor,  # (M, R, T) zero-padded realisations
    mask: torch.Tensor,  # (M, R)
    kernel_name: str = "matern32",
    n_optim_nits: int = 500,
    learning_rate: float = 0.01,
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
    jitter: float = 1e-6,
    optimizer: str = "adam",
    gp_init: tp.Optional[gp_ops.BatchedGPParams] = None,
    return_params: bool = False,
    return_targets: bool = False,
    time_stride: int = 1,
    fine_steps: tp.Optional[int] = None,
):
    """Batched GPDTW1D emulation returning posterior marginals ``(M, T)`` x2.

    The marginal variance includes the heteroskedastic noise.  ``gp_init``
    starts the fit from given hyperparameters (e.g. JAX-fitted ones carried
    over with :func:`bayesian_ensembling_tpu_torch.convert.gp_params_from_jax`);
    ``return_params`` also returns the fitted :class:`BatchedGPParams`, and
    ``return_targets`` (with ``return_params``) the DBA targets
    ``(y_mean, y_var)``.
    """
    if return_targets and not return_params:
        raise ValueError("return_targets requires return_params=True")
    x, y_mean, y_var = gp_ops.prepare_gp_inputs(
        block, mask, dba_iterations=dba_iterations, dba_method=dba_method, dba_tol=dba_tol
    )
    params, _ = gp_ops.fit_gp_batch_dispatch(
        x,
        y_mean,
        y_var,
        kernel_name=kernel_name,
        n_optim_nits=n_optim_nits,
        learning_rate=learning_rate,
        jitter=jitter,
        optimizer=optimizer,
        init=gp_init,
        time_stride=time_stride,
        fine_steps=fine_steps,
    )
    mean, var = gp_ops.posterior_marginals_batch(
        params, x, y_mean, y_var, kernel_name=kernel_name, jitter=jitter
    )
    if return_targets:
        return mean, var + y_var, params, y_mean, y_var
    if return_params:
        return mean, var + y_var, params
    return mean, var + y_var


def chunked_marginals(em, block: torch.Tensor, mask: torch.Tensor, chunk: int):
    """Run an emulator ``em(block, mask) -> (mean, var)`` over a merged
    ``(B, R, T)`` batch in model chunks of ``chunk``, one call per chunk.

    Bounds the peak device memory of the fit at one chunk's working set
    (several ``(chunk, T, T)`` buffers at the monthly historical T = 1980).
    When ``B % chunk != 0`` the last chunk is padded with replicated real
    rows (tiled when the pad exceeds the batch), so every chunk has one
    shape and the padded rows run well-conditioned math; their results are
    sliced off.
    """
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    b = block.shape[0]
    g = -(-b // chunk)
    pad = g * chunk - b
    if pad:
        reps = -(-pad // b)
        block = torch.cat([block] + [block] * reps, dim=0)[: g * chunk]
        mask = torch.cat([mask] + [mask] * reps, dim=0)[: g * chunk]
    means, varis = [], []
    for i in range(g):
        mu, var = em(block[i * chunk : (i + 1) * chunk], mask[i * chunk : (i + 1) * chunk])
        means.append(mu)
        varis.append(var)
    return torch.cat(means)[:b], torch.cat(varis)[:b]


def _barycentre(weights, ssp_mean, ssp_var, sigma_mode):
    """W2 (or moment-matched mixture) barycentre over the model axis (-2)."""
    w = weights[..., None]
    bary_mean = torch.sum(w * ssp_mean, dim=-2)
    if sigma_mode == "mixture":
        dev = ssp_mean - bary_mean[..., None, :]
        bary_std = torch.sqrt(torch.sum(w * (ssp_var + dev * dev), dim=-2))
    else:
        bary_std = torch.sum(w * torch.sqrt(ssp_var), dim=-2)
    return bary_mean, bary_std


def _check_step_options(weight_kind, sigma_mode, model_axis):
    """Refuse what the tail cannot do before the emulation runs."""
    if weight_kind not in WEIGHT_KINDS:
        raise ValueError(f"unknown weight_kind {weight_kind!r}; one of {WEIGHT_KINDS}")
    if sigma_mode not in _SIGMA_MODES:
        raise ValueError(f"fused step supports sigma_mode 'w2' | 'mixture', got {sigma_mode!r}")
    if model_axis is not None:
        raise not_ported("model_axis (model-sharded step)", "A10")


def multi_scenario_tail(
    hist_mean: torch.Tensor,  # (S, M, T_hist)
    hist_var: torch.Tensor,  # (S, M, T_hist)
    ssp_mean: torch.Tensor,  # (S, M, T_ssp)
    ssp_var: torch.Tensor,  # (S, M, T_ssp)
    obs: torch.Tensor,  # (R_obs, T_hist)
    hist_blocks: torch.Tensor,  # (S, M, R, T_hist) raw realisations
    hist_masks: torch.Tensor,  # (S, M, R)
    model_masks: torch.Tensor,  # (S, M)
    *,
    weight_kind: str = "crps",
    model_axis: tp.Optional[str] = None,
    sigma_mode: str = "w2",
):
    """Weighting + barycentre tail given the emulated marginals: raw
    weights, masked and normalised to sum to one per scenario and
    timestep, time-mean, then the barycentre.  Returns
    ``(bary_mean (S, T_ssp), bary_std (S, T_ssp), weights (S, M))``.

    The raw weights are computed one scenario at a time, which bounds the
    ``ksd`` weights' ``(M, T, R_obs, R_obs)`` temporaries at one scenario's.
    """
    _check_step_options(weight_kind, sigma_mode, model_axis)
    raw = torch.stack([
        fused_raw_weights(weight_kind, hist_mean[i], hist_var[i], obs, hist_blocks[i],
                          hist_masks[i], model_masks[i])
        for i in range(hist_mean.shape[0])
    ])
    raw = raw * model_masks[:, :, None]
    weights = torch.mean(raw / torch.sum(raw, dim=1, keepdim=True), dim=2)
    bary_mean, bary_std = _barycentre(weights, ssp_mean, ssp_var, sigma_mode)
    return bary_mean, bary_std, weights


def ensemble_scenario_step(
    hist_block: torch.Tensor,  # (M, R, T_hist)
    hist_mask: torch.Tensor,  # (M, R)
    ssp_block: torch.Tensor,  # (M, R, T_ssp)
    ssp_mask: torch.Tensor,  # (M, R)
    obs: torch.Tensor,  # (R_obs, T_hist)
    model_mask: tp.Optional[torch.Tensor] = None,  # (M,) 1 = real, 0 = padded
    *,
    kernel_name: str = "matern32",
    n_optim_nits: int = 500,
    learning_rate: float = 0.01,
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
    weight_kind: str = "crps",
    optimizer: str = "adam",
    model_axis: tp.Optional[str] = None,
    sigma_mode: str = "w2",
    time_stride: int = 1,
    fine_steps: tp.Optional[int] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One full scenario: emulate hist + ssp, weight against obs, W2
    barycentre.  Returns ``(bary_mean (T_ssp,), bary_std (T_ssp,),
    weights (M,))``."""
    _check_step_options(weight_kind, sigma_mode, model_axis)
    em = dict(
        kernel_name=kernel_name, n_optim_nits=n_optim_nits, learning_rate=learning_rate,
        dba_iterations=dba_iterations, dba_method=dba_method, dba_tol=dba_tol,
        optimizer=optimizer, time_stride=time_stride, fine_steps=fine_steps,
    )
    hist_mean, hist_var = emulate_marginals(hist_block, hist_mask, **em)
    ssp_mean, ssp_var = emulate_marginals(ssp_block, ssp_mask, **em)
    raw = fused_raw_weights(weight_kind, hist_mean, hist_var, obs, hist_block, hist_mask,
                            model_mask)
    if model_mask is not None:
        raw = raw * model_mask[:, None]
    weights = torch.mean(raw / torch.sum(raw, dim=0, keepdim=True), dim=1)
    bary_mean, bary_std = _barycentre(weights, ssp_mean, ssp_var, sigma_mode)
    return bary_mean, bary_std, weights


def ensemble_multi_scenario_step(
    hist_blocks: torch.Tensor,  # (S, M, R, T_hist)
    hist_masks: torch.Tensor,  # (S, M, R)
    ssp_blocks: torch.Tensor,  # (S, M, R, T_ssp)
    ssp_masks: torch.Tensor,  # (S, M, R)
    obs: torch.Tensor,  # (R_obs, T_hist)
    model_masks: torch.Tensor,  # (S, M)
    *,
    kernel_name: str = "matern32",
    n_optim_nits: int = 500,
    learning_rate: float = 0.01,
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
    weight_kind: str = "crps",
    optimizer: str = "adam",
    model_axis: tp.Optional[str] = None,
    sigma_mode: str = "w2",
    time_stride: int = 1,
    fine_steps: tp.Optional[int] = None,
):
    """All scenarios at once: each collection is emulated as one batch of
    ``S*M`` models, then the per-scenario tail.  Returns
    ``(bary_mean (S, T_ssp), bary_std (S, T_ssp), weights (S, M))``."""
    _check_step_options(weight_kind, sigma_mode, model_axis)
    s, m, r, t_hist = hist_blocks.shape
    t_ssp = ssp_blocks.shape[-1]
    em = dict(
        kernel_name=kernel_name, n_optim_nits=n_optim_nits, learning_rate=learning_rate,
        dba_iterations=dba_iterations, dba_method=dba_method, dba_tol=dba_tol,
        optimizer=optimizer, time_stride=time_stride, fine_steps=fine_steps,
    )
    hist_mean, hist_var = emulate_marginals(
        hist_blocks.reshape(s * m, r, t_hist), hist_masks.reshape(s * m, r), **em
    )
    ssp_mean, ssp_var = emulate_marginals(
        ssp_blocks.reshape(s * m, r, t_ssp), ssp_masks.reshape(s * m, r), **em
    )
    return multi_scenario_tail(
        hist_mean.reshape(s, m, t_hist),
        hist_var.reshape(s, m, t_hist),
        ssp_mean.reshape(s, m, t_ssp),
        ssp_var.reshape(s, m, t_ssp),
        obs,
        hist_blocks,
        hist_masks,
        model_masks,
        weight_kind=weight_kind,
        sigma_mode=sigma_mode,
    )


def pad_models(
    block: np.ndarray, mask: np.ndarray, m_target: int
) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad the model axis to ``m_target``.

    Padded entries replicate model 0 (their fit is wasted but numerically
    safe) and are zeroed out of the weights via the returned model_mask.
    """
    m = block.shape[0]
    if m_target < m:
        raise ValueError(f"m_target {m_target} < {m}")
    reps = [block] + [block[:1]] * (m_target - m)
    mreps = [mask] + [mask[:1]] * (m_target - m)
    model_mask = np.concatenate([np.ones(m), np.zeros(m_target - m)]).astype(block.dtype)
    return np.concatenate(reps, 0), np.concatenate(mreps, 0), model_mask


def _to(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``a`` (numpy or tensor) on ``device`` in ``dtype``, booleans kept."""
    a = torch.as_tensor(a).detach()
    return a.to(device, torch.bool if a.dtype == torch.bool else dtype)


def refined_multi_scenario_f64(
    hb,  # (S, M, R, T_hist)
    hm,  # (S, M, R)
    sb,  # (S, M, R, T_ssp)
    sm,  # (S, M, R)
    obs,  # (R_obs, T_hist)
    model_masks,  # (S, M)
    hist_params,  # BatchedGPParams with leading (S*M,) axis, e.g. float32-fitted
    ssp_params,
    *,
    kernel_name: str = "matern32",
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
    jitter: float = 1e-6,
    weight_kind: str = "crps",
    sigma_mode: str = "w2",
    targets=None,  # optional ((h_y_mean, h_y_var), (s_y_mean, s_y_var))
    device: tp.Union[str, torch.device] = "cuda",
):
    """Float64 posterior and tail at given hyperparameters and DBA targets.

    The float32 pipeline's residual error against a float64 recompute at
    the same hyperparameters and targets is the float32 solve scatter; this
    pass removes it from the published moments while the fit stays in
    float32.  It re-runs only the posterior marginals and the weighting and
    barycentre tail in float64, on ``device`` (the card unless the caller
    asks for ``"cpu"``; a CUDA device without CUDA raises).  At the annual
    T = 165 / 86 the float64 posterior takes the Cholesky-solve and
    triangular-inverse kernels.

    Inputs are numpy arrays or tensors.  ``targets``: the fit's own
    ``((h_y_mean, h_y_var), (s_y_mean, s_y_var))``; when omitted they are
    recomputed through the fit's preamble (``prepare_gp_inputs``) in the
    blocks' own dtype.

    Returns ``(bary_mean, bary_std, weights)`` as float64 numpy arrays.
    """
    _check_step_options(weight_kind, sigma_mode, None)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "refined_multi_scenario_f64: CUDA is not available; pass device='cpu' to run on the CPU"
        )
    f64 = torch.float64
    s, m, r, t_hist = hb.shape
    t_ssp = sb.shape[-1]
    if targets is None:
        prep = functools.partial(gp_ops.prepare_gp_inputs, dba_iterations=dba_iterations,
                                 dba_method=dba_method, dba_tol=dba_tol)
        hb_t, sb_t = torch.as_tensor(hb, device=device), torch.as_tensor(sb, device=device)
        _, h_ym, h_yv = prep(hb_t.reshape(s * m, r, t_hist),
                             torch.as_tensor(hm, device=device).reshape(s * m, r))
        _, s_ym, s_yv = prep(sb_t.reshape(s * m, r, t_ssp),
                             torch.as_tensor(sm, device=device).reshape(s * m, r))
    else:
        (h_ym, h_yv), (s_ym, s_yv) = targets

    def marginals(params, block, t, ym, yv):
        p64 = gp_ops.BatchedGPParams(_to(params.raw_lengthscale, f64, device),
                                     _to(params.raw_variance, f64, device))
        x = _to(block, f64, device).reshape(s * m, r, t).transpose(1, 2)
        ym, yv = _to(ym, f64, device), _to(yv, f64, device)
        mu, var = gp_ops.posterior_marginals_batch(p64, x, ym, yv, kernel_name=kernel_name,
                                                   jitter=jitter)
        return mu.reshape(s, m, t), (var + yv).reshape(s, m, t)

    h_mu, h_var = marginals(hist_params, hb, t_hist, h_ym, h_yv)
    s_mu, s_var = marginals(ssp_params, sb, t_ssp, s_ym, s_yv)
    with torch.no_grad():
        out = multi_scenario_tail(
            h_mu, h_var, s_mu, s_var, _to(obs, f64, device), _to(hb, f64, device),
            _to(hm, f64, device), _to(model_masks, f64, device),
            weight_kind=weight_kind, sigma_mode=sigma_mode,
        )
    return tuple(a.cpu().numpy() for a in out)
