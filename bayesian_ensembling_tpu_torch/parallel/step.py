"""The ensemble step: DBA -> GP fit -> posterior marginals -> CRPS weights ->
W2 barycentre.

PyTorch counterpart of ``bayesian_ensembling_tpu/parallel/step.py``,
unsharded main path.  :func:`ensemble_multi_scenario_step` merges the
(scenario, model) axes so that each collection (historical, SSP) is emulated
in one batch of ``S*M`` models; the per-scenario weighting and barycentre
tail is elementwise work.  Options of the JAX step that the port lacks raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import not_ported
from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
from bayesian_ensembling_tpu_torch.ops import scoring

__all__ = [
    "chunked_marginals",
    "emulate_marginals",
    "fused_raw_weights",
    "ensemble_scenario_step",
    "ensemble_multi_scenario_step",
    "multi_scenario_tail",
    "pad_models",
]

_SIGMA_MODES = ("w2", "mixture")


def fused_raw_weights(
    weight_kind: str,
    hist_mean: torch.Tensor,  # (..., M, T) posterior marginal means
    hist_var: torch.Tensor,  # (..., M, T) marginal variances incl. noise
    obs: torch.Tensor,  # (R_obs, T)
) -> torch.Tensor:
    """Raw (un-normalised) weight scores ``(..., M, T)``: 1 / mean Gaussian
    CRPS against the observation realisations (``weight_kind="crps"``).

    The reciprocal floors the score at sqrt(tiny): an exact zero would give
    inf and inf/inf = NaN in the sum-to-one normalisation, while 1/tiny
    would overflow the sum over a few floored models.
    """
    if weight_kind != "crps":
        raise not_ported(f"weight_kind={weight_kind!r}", "A6")
    score = scoring.mean_gaussian_crps(hist_mean, torch.sqrt(hist_var), obs)
    floor = float(np.sqrt(torch.finfo(score.dtype).tiny))
    return 1.0 / torch.clamp(score, min=floor)


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
    if weight_kind != "crps":
        raise not_ported(f"weight_kind={weight_kind!r}", "A6")
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
    hist_blocks: tp.Optional[torch.Tensor],  # (S, M, R, T_hist), unused by crps
    hist_masks: tp.Optional[torch.Tensor],  # (S, M, R), unused by crps
    model_masks: torch.Tensor,  # (S, M)
    *,
    weight_kind: str = "crps",
    model_axis: tp.Optional[str] = None,
    sigma_mode: str = "w2",
):
    """Weighting + barycentre tail given the emulated marginals: raw
    weights, masked and normalised to sum to one per scenario and
    timestep, time-mean, then the barycentre.  Returns
    ``(bary_mean (S, T_ssp), bary_std (S, T_ssp), weights (S, M))``."""
    _check_step_options(weight_kind, sigma_mode, model_axis)
    raw = fused_raw_weights(weight_kind, hist_mean, hist_var, obs)
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
    raw = fused_raw_weights(weight_kind, hist_mean, hist_var, obs)
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
