"""GPDTW1D: the flagship emulator, DBA mean + heteroskedastic exact GP.

PyTorch counterpart of ``bayesian_ensembling_tpu/models/gp_dtw.py``.  The
pipeline per model:
(a) DTW-barycentre of the realisations -> target mean ``y``
(b) across-realisation variance -> *known* per-point noise
(c) features ``X`` = the realisation matrix transposed (time-major)
(d)+(e) kernel hyperparameters optimised on the exact NLML
(f) exact posterior with full covariance, plus ``diag(y_var)``.

Because the likelihood's noise is known, the reference's variational GP has
the exact GP regression as its optimum, so (d)-(f) are Cholesky-based closed
forms (see ``ops/gp.py``).  The whole collection, every climate model, is
fitted as one batch.  Ragged realisation counts are zero-padded + masked
(zero feature columns are distance-neutral).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import resolve_device
from bayesian_ensembling_tpu_torch.data import ModelCollection, Posterior
from bayesian_ensembling_tpu_torch.models.base import AbstractEmulator
from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
from bayesian_ensembling_tpu_torch.ops.distributions import FullCovGaussian
from bayesian_ensembling_tpu_torch.utils.config import GPRParameters

__all__ = ["GPDTW1D", "emulate_batch", "emulate_batch_chunked", "refine_posterior_f64"]


def _posterior_with_noise(params, x, y_mean, y_var, kernel_name="matern32", jitter=1e-6):
    """Stage (f): exact posterior + heteroskedastic noise diagonal."""
    mean, cov = gp_ops.posterior_batch(params, x, y_mean, y_var, kernel_name=kernel_name,
                                       jitter=jitter)
    return mean, cov + torch.diag_embed(y_var)


def emulate_batch_chunked(
    block: torch.Tensor,
    mask: torch.Tensor,
    kernel_name: str = "matern32",
    n_optim_nits: int = 500,
    learning_rate: float = 0.01,
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
    jitter: float = 1e-6,
    optimizer: str = "adam",
    fit_chunk_steps: tp.Optional[int] = 250,
    time_stride: int = 1,
    fine_steps: tp.Optional[int] = None,
    return_params: bool = False,
):
    """:func:`emulate_batch` with the optimisation as a host loop of
    ``fit_chunk_steps``-long segments, each ended by a device
    synchronisation (``ops/gp.fit_gp_batch_chunked``).  Same math, same step
    sequence, same return contract; each segment bounds one uninterrupted
    stretch of device work."""
    x, y_mean, y_var = gp_ops.prepare_gp_inputs(
        block, mask, dba_iterations=dba_iterations, dba_method=dba_method, dba_tol=dba_tol
    )
    params, losses = gp_ops.fit_gp_batch_dispatch(
        x, y_mean, y_var,
        kernel_name=kernel_name,
        n_optim_nits=n_optim_nits,
        learning_rate=learning_rate,
        jitter=jitter,
        optimizer=optimizer,
        time_stride=time_stride,
        fine_steps=fine_steps,
        chunk_steps=fit_chunk_steps,
    )
    mean, cov = _posterior_with_noise(params, x, y_mean, y_var, kernel_name=kernel_name,
                                      jitter=jitter)
    if return_params:
        return mean, cov, losses, params, y_mean, y_var
    return mean, cov, losses


def emulate_batch(
    block: torch.Tensor,  # (M, R, T) zero-padded realisations
    mask: torch.Tensor,  # (M, R) validity
    kernel_name: str = "matern32",
    n_optim_nits: int = 500,
    learning_rate: float = 0.01,
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
    jitter: float = 1e-6,
    optimizer: str = "adam",
    time_stride: int = 1,
    fine_steps: tp.Optional[int] = None,
    return_params: bool = False,
):
    """Fit every model's emulator in one batch, on the device of ``block``.

    Returns ``(mean (M, T), cov (M, T, T), nlml_trace)``: the trace is
    ``(M, n_optim_nits)`` for the scratch fit, ``(M, n_optim_nits +
    fine_steps)`` for the warm-in-time fit (coarse NLMLs of the strided
    series followed by full-T fine NLMLs; not comparable across the
    boundary).  ``return_params=True`` appends the fitted
    :class:`~bayesian_ensembling_tpu_torch.ops.gp.BatchedGPParams` and the
    DBA targets, ``(..., params, y_mean (M, T), y_var (M, T))``: the inputs
    the float64 refinement takes, so that it never re-runs the DBA preamble.
    The covariance already includes the heteroskedastic noise diagonal, i.e.
    it is the posterior over *observables*.

    ``time_stride > 1`` runs the hyperparameter fit coarse-to-fine in time:
    ``n_optim_nits`` coarse steps on every ``time_stride``-th timestep, then
    ``fine_steps`` (required) warm-started steps at full T.
    """
    return emulate_batch_chunked(
        block, mask, kernel_name=kernel_name, n_optim_nits=n_optim_nits,
        learning_rate=learning_rate, dba_iterations=dba_iterations, dba_method=dba_method,
        dba_tol=dba_tol, jitter=jitter, optimizer=optimizer, fit_chunk_steps=None,
        time_stride=time_stride, fine_steps=fine_steps, return_params=return_params,
    )


def refine_posterior_f64(
    block,  # (M, R, T), numpy or tensor
    mask,  # (M, R)
    params: gp_ops.BatchedGPParams,  # (M,) leaves, e.g. float32-converged
    *,
    kernel_name: str = "matern32",
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
    jitter: float = 1e-6,
    targets: tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]] = None,
    device: tp.Union[str, torch.device] = "cuda",
):
    """Float64 posterior recompute at float32-converged hyperparameters.

    The full-covariance counterpart of
    ``parallel/step.refined_multi_scenario_f64``: the fit stays in float32,
    and only stage (f), Gram, Cholesky and solves, is re-run in float64
    with the fit's hyperparameters and its DBA targets unchanged, which
    removes the float32 solve scatter from the published moments.  Float64
    is native on ``device`` (the card unless the caller asks for
    ``"cpu"``; a CUDA device without CUDA raises).

    ``targets``: the fit's own ``(y_mean, y_var)`` (from
    ``emulate_batch(..., return_params=True)``), which skips the DBA
    dynamic program; when omitted they are recomputed through the fit's
    preamble in the block's own dtype.

    Returns ``(mean (M, T), cov (M, T, T))`` as float64 tensors on
    ``device``.
    """
    device = resolve_device(device, "refine_posterior_f64")
    block = torch.as_tensor(block).to(device)
    if targets is not None:
        y_mean, y_var = targets
    else:
        _, y_mean, y_var = gp_ops.prepare_gp_inputs(
            block, torch.as_tensor(mask).to(device), dba_iterations=dba_iterations,
            dba_method=dba_method, dba_tol=dba_tol,
        )
    f64 = torch.float64
    p64 = gp_ops.BatchedGPParams(params.raw_lengthscale.detach().to(device, f64),
                                 params.raw_variance.detach().to(device, f64))
    return _posterior_with_noise(
        p64, block.to(f64).transpose(1, 2), torch.as_tensor(y_mean).to(device, f64),
        torch.as_tensor(y_var).to(device, f64), kernel_name=kernel_name, jitter=jitter,
    )


class GPDTW1D(AbstractEmulator):
    """DBA-mean heteroskedastic GP emulator for 1-D (realisation, time) data.

    Defaults come from a typed
    :class:`~bayesian_ensembling_tpu_torch.utils.config.GPRParameters`
    config; explicit ``fit`` kwargs override it per call.
    """

    def __init__(
        self,
        name: str = "GPRegressor",
        kernel: tp.Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        config: tp.Optional[GPRParameters] = None,
    ) -> None:
        super().__init__(name)
        self.config = config or GPRParameters()
        self.kernel = kernel if kernel is not None else self.config.kernel
        self.dtype = dtype

    def fit_collection(
        self,
        collection: ModelCollection,
        n_optim_nits: tp.Optional[int] = None,
        learning_rate: tp.Optional[float] = None,
        dba_iterations: tp.Optional[int] = None,
        dba_method: tp.Optional[str] = None,
        dba_tol: tp.Optional[float] = None,
        jitter: tp.Optional[float] = None,
        optimizer: str = "adam",
        fit_chunk_steps: tp.Optional[int] = None,
        time_stride: int = 1,
        fine_steps: tp.Optional[int] = None,
        refine_f64: bool = False,
        refine_device: tp.Union[str, torch.device, None] = None,
        device: tp.Union[str, torch.device] = "cuda",
        **_: tp.Any,
    ) -> tp.List[Posterior]:
        """Fit the collection on ``device`` (the card unless the caller asks
        for ``"cpu"``); the posteriors' moments stay there.  ``refine_f64``
        publishes float64 moments recomputed on ``refine_device`` (``device``
        when omitted)."""
        device = resolve_device(device, "GPDTW1D.fit_collection")
        cfg = self.config
        n_optim_nits = cfg.n_optim_nits if n_optim_nits is None else n_optim_nits
        learning_rate = cfg.learning_rate if learning_rate is None else learning_rate
        dba_iterations = cfg.dba_iterations if dba_iterations is None else dba_iterations
        dba_method = cfg.dba_method if dba_method is None else dba_method
        jitter = cfg.jitter if jitter is None else jitter
        if collection[0].ndim > 2:
            raise NotImplementedError(
                "GPDTW1D handles (realisation, time) data only; fit gridded "
                "(realisation, time, latitude, longitude) fields with GPDTW3D"
            )
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        block, mask = collection.padded_stack(dtype=np_dtype)
        block, mask = torch.as_tensor(block, device=device), torch.as_tensor(mask, device=device)
        # fit_chunk_steps=0 reaches the chunked fit's ValueError instead of
        # silently running the merged fit.
        out = emulate_batch_chunked(
            block, mask,
            kernel_name=self.kernel,
            n_optim_nits=n_optim_nits,
            learning_rate=learning_rate,
            dba_iterations=dba_iterations,
            dba_method=dba_method,
            dba_tol=dba_tol,
            jitter=jitter,
            optimizer=optimizer,
            fit_chunk_steps=fit_chunk_steps,
            time_stride=time_stride,
            fine_steps=fine_steps,
            return_params=refine_f64,
        )
        mean, cov = out[0], out[1]
        if refine_f64:
            # Published moments in float64 at the converged hyperparameters;
            # the fit's own targets skip a second DBA pass.
            mean, cov = refine_posterior_f64(
                block, mask, out[3],
                kernel_name=self.kernel, dba_iterations=dba_iterations,
                dba_method=dba_method, dba_tol=dba_tol, jitter=jitter,
                targets=(out[4], out[5]),
                device=device if refine_device is None else refine_device,
            )
        return [
            Posterior(gaussian=FullCovGaussian(mean=mean[i], cov=cov[i]),
                      template=pm.blank_template())
            for i, pm in enumerate(collection)
        ]
