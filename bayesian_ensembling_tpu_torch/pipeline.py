"""End-to-end GMST experiment pipeline, the part that reads no files.

PyTorch counterpart of ``bayesian_ensembling_tpu/pipeline.py``:
:func:`run_scenario` emulates every model of a scenario's historical and
SSP collections with
:class:`~bayesian_ensembling_tpu_torch.models.gp_dtw.GPDTW1D`, weights them
against observations (CRPS by default) and combines them with the W2
:class:`~bayesian_ensembling_tpu_torch.schemes.Barycentre`.  Each collection
is fitted as one batch on the card.  :func:`run_gridded_scenario` is the
gridded counterpart: :class:`~bayesian_ensembling_tpu_torch.models.gp_3d.GPDTW3D`
per (lat, lon) cell, weights per point, the per-point barycentre.  The
netCDF loaders are not ported yet and raise ``NotImplementedError`` naming
their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time as _time
import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import not_ported, resolve_device
from bayesian_ensembling_tpu_torch.data import ModelCollection, Posterior, ProcessModel
from bayesian_ensembling_tpu_torch.io import timeutils
from bayesian_ensembling_tpu_torch.models.gp_dtw import GPDTW1D
from bayesian_ensembling_tpu_torch.schemes import Barycentre
from bayesian_ensembling_tpu_torch.utils.profiles import resolve_profile
from bayesian_ensembling_tpu_torch.weights import CRPSWeight

__all__ = [
    "ALL_SSPS",
    "default_data_dir",
    "ScenarioResult",
    "load_observations",
    "load_scenario",
    "load_packed_scenarios",
    "run_scenario",
    "run_gridded_scenario",
    "warming_summary",
]

ALL_SSPS = ("ssp119", "ssp126", "ssp245", "ssp370", "ssp434", "ssp460", "ssp585")


def default_data_dir() -> str:
    raise not_ported("pipeline.default_data_dir (the netCDF data layout)", "A7b")


def load_observations(*args, **kwargs) -> ProcessModel:
    raise not_ported("pipeline.load_observations (the netCDF reader)", "A7b")


def load_scenario(*args, **kwargs) -> tp.Tuple[ModelCollection, ModelCollection]:
    raise not_ported("pipeline.load_scenario (the netCDF reader)", "A7b")


def load_packed_scenarios(*args, **kwargs):
    raise not_ported("pipeline.load_packed_scenarios (the netCDF reader)", "A7b")


@dataclasses.dataclass
class ScenarioResult:
    ssp: str
    weights: tp.Any  # DimArray (model, time)
    barycentre: Posterior
    fit_seconds: float
    total_seconds: float


def run_scenario(
    hist: ModelCollection,
    ssp_collection: ModelCollection,
    observations: ProcessModel,
    ssp_name: str = "ssp",
    weighter: tp.Optional[tp.Any] = None,
    emulator: tp.Optional[tp.Any] = None,
    n_optim_nits: int = 2000,
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
    sigma_mode: str = "w2",
    fit_chunk_steps: tp.Optional[int] = None,
    time_stride: int = 1,
    fine_steps: tp.Optional[int] = None,
    optimizer: str = "adam",
    profile: tp.Optional[str] = None,
    refine_f64: bool = False,
    refine_device: tp.Union[str, torch.device, None] = None,
    device: tp.Union[str, torch.device] = "cuda",
) -> ScenarioResult:
    """Fit + weight + combine one scenario on ``device`` (the card unless
    the caller asks for ``"cpu"``; a CUDA device without CUDA raises).

    ``sigma_mode``: combined-sigma convention, "w2" (closed-form
    barycentre, default), "compat" (reference fixed point) or "mixture"
    (calibrated moment-matched mixture; see ``schemes.Barycentre``).
    ``fit_chunk_steps``: optional host-chunked fit (``GPDTW1D``
    ``fit_chunk_steps``), each chunk ended by a device synchronisation.
    ``time_stride``/``fine_steps``: coarse-to-fine-in-time fit for native
    monthly resolution (``ops/gp.fit_gp_batch_warm_time``).
    ``optimizer``: "adam" (reference-faithful default) or "bfgs"
    (per-model damped quasi-Newton; use with n_optim_nits ~ 30-60).
    ``profile``: "faithful" (default, no changes) | "fast", one switch for
    the preset schedule of the workload's regime (``utils/profiles.py``;
    resolution inferred from the historical time axis).  Mutually exclusive
    with setting the fit knobs explicitly.
    ``refine_f64``: recompute the published posterior moments in float64
    at the float32-converged hyperparameters
    (``models/gp_dtw.refine_posterior_f64``) on ``refine_device``
    (``device`` when omitted); the weighting and combination tail then runs
    in float64 too, because it computes in the moments' dtype.

    ``fit_seconds`` and ``total_seconds`` are host wall times ended by a
    device synchronisation.
    """
    device = resolve_device(device, "run_scenario")
    weighter = weighter or CRPSWeight()
    emulator = emulator or GPDTW1D()

    if profile is not None and profile != "faithful":
        # The profile OWNS the fit knobs, so it must not silently fight
        # explicit values: callers choose one or the other.
        explicit = {
            "n_optim_nits": n_optim_nits != 2000,
            "optimizer": optimizer != "adam",
            "time_stride": time_stride != 1,
            "fine_steps": fine_steps is not None,
        }
        clash = [k for k, v in explicit.items() if v]
        if clash:
            raise ValueError(
                f"profile={profile!r} sets {clash} itself; pass either the "
                "profile or the explicit fit knobs, not both"
            )
        # Native monthly = the large-T regime (monthly historical series
        # are ~1980 steps; anything resampled is two orders smaller).
        native_monthly = len(hist.time) > 1000
        kw = resolve_profile(profile, native_monthly=native_monthly)
        n_optim_nits = kw.get("n_optim_nits", n_optim_nits)
        optimizer = kw.get("optimizer", optimizer)
        time_stride = kw.get("time_stride", time_stride)
        fine_steps = kw.get("fine_steps", fine_steps)

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = _time.perf_counter()
    fit_kw = dict(
        n_optim_nits=n_optim_nits,
        dba_iterations=dba_iterations,
        dba_method=dba_method,
        dba_tol=dba_tol,
        fit_chunk_steps=fit_chunk_steps,
        time_stride=time_stride,
        fine_steps=fine_steps,
        optimizer=optimizer,
        refine_f64=refine_f64,
        refine_device=refine_device,
        device=device,
    )
    hist.fit(emulator, **fit_kw)
    ssp_collection.fit(emulator, **fit_kw)
    _sync()
    t_fit = _time.perf_counter() - t0

    w = weighter(hist, observations)
    # One weight per model: time-mean, broadcast over the forecast period.
    # Weighters that already return one weight per model (similarity
    # mode="single" is dimensionless) skip the reduction.
    w_mean = w.mean("time") if "time" in w.dims else w
    w_fore = w_mean.expand_dims(
        "time", size=len(ssp_collection.time), coord=ssp_collection.time, axis=1,
    )
    barycentre = Barycentre()(ssp_collection, w_fore, sigma_mode=sigma_mode)
    _sync()
    total = _time.perf_counter() - t0
    return ScenarioResult(ssp_name, w_fore, barycentre, t_fit, total)


def run_gridded_scenario(
    collection: ModelCollection,
    observations: ProcessModel,
    weighter: tp.Optional[tp.Any] = None,
    emulator: tp.Optional[tp.Any] = None,
    n_optim_nits: int = 500,
    dba_iterations: int = 10,
    dba_method: str = "classic",
    dba_tol: tp.Optional[float] = None,
    sigma_mode: str = "w2",
    refine_f64: bool = False,
    refine_device: tp.Union[str, torch.device, None] = None,
    refine_cell_chunk: tp.Optional[int] = None,
    device: tp.Union[str, torch.device] = "cuda",
) -> tp.Tuple[tp.Any, Posterior]:
    """Gridded fit -> weight -> combine, on ``device`` (the card unless the
    caller asks for ``"cpu"``; a CUDA device without CUDA raises).

    Every (model, cell) pair is emulated as an independent DBA + exact GP
    (``GPDTW3D`` batched mode by default), weighted per point against the
    gridded observations (CRPS by default) and combined with the per-point
    W2 barycentre.  Returns ``(weights DimArray, barycentre Posterior)``.

    ``refine_f64`` publishes float64 per-cell moments recomputed at the
    float32-converged hyperparameters on ``refine_device`` (``device`` when
    omitted), in cell pieces of ``refine_cell_chunk``; the weighting and
    combination then run in float64 too, because they compute in the
    moments' dtype.
    """
    from bayesian_ensembling_tpu_torch.models.gp_3d import GPDTW3D

    device = resolve_device(device, "run_gridded_scenario")
    weighter = weighter or CRPSWeight()
    emulator = emulator or GPDTW3D()
    collection.fit(
        emulator, n_optim_nits=n_optim_nits, dba_iterations=dba_iterations,
        dba_method=dba_method, dba_tol=dba_tol, refine_f64=refine_f64,
        refine_device=refine_device, refine_cell_chunk=refine_cell_chunk, device=device,
    )
    weights = weighter(collection, observations)
    bary = Barycentre()(collection, weights, sigma_mode=sigma_mode)
    return weights, bary


def warming_summary(
    result: ScenarioResult, years=(2050, 2100)
) -> tp.Dict[int, tp.Tuple[float, float, float]]:
    """Mean and 95% credible interval of warming at selected years."""
    post = result.barycentre
    t_years = timeutils.years_of(post.template.time)
    mean = post.mean.values.ravel()
    sd = post.stddev.values.ravel()
    out = {}
    for y in years:
        idx = int(np.argmin(np.abs(t_years - y)))
        out[y] = (
            float(mean[idx]),
            float(mean[idx] - 2 * sd[idx]),
            float(mean[idx] + 2 * sd[idx]),
        )
    return out
