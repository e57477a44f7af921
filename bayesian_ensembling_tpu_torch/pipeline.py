"""End-to-end GMST experiment pipeline.

PyTorch counterpart of ``bayesian_ensembling_tpu/pipeline.py``:
:func:`run_scenario` emulates every model of a scenario's historical and
SSP collections with
:class:`~bayesian_ensembling_tpu_torch.models.gp_dtw.GPDTW1D`, weights them
against observations (CRPS by default) and combines them with the W2
:class:`~bayesian_ensembling_tpu_torch.schemes.Barycentre`.  Each collection
is fitted as one batch on the card.  :func:`run_gridded_scenario` is the
gridded counterpart: :class:`~bayesian_ensembling_tpu_torch.models.gp_3d.GPDTW3D`
per (lat, lon) cell, weights per point, the per-point barycentre.  The
loaders read HadCRUT5 observations and per-SSP CMIP6 members from netCDF
files (``io/netcdf.py``) and anomalise them against the 1961-1990 monthly
climatology; they return numpy-backed containers, and the device enters at
``fit``.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time as _time
import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import resolve_device
from bayesian_ensembling_tpu_torch.coords import DimArray
from bayesian_ensembling_tpu_torch.data import ModelCollection, Posterior, ProcessModel
from bayesian_ensembling_tpu_torch.io import netcdf, timeutils
from bayesian_ensembling_tpu_torch.models.gp_dtw import GPDTW1D
from bayesian_ensembling_tpu_torch.parallel.step import pad_models
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
    """Resolve the GMST data directory.

    Priority: ``$BET_DATA_DIR`` > ``experiments/data`` beside the package.
    The layout is the reference's ``experiments/data``: ``obs/gmst/*.nc``
    and ``gmst/<scenario>/*.nc``.
    """
    env = os.environ.get("BET_DATA_DIR")
    if env:
        if not os.path.isdir(env):
            raise FileNotFoundError(
                f"BET_DATA_DIR={env!r} is not a directory; expected the "
                "layout of the reference's experiments/data "
                "(obs/gmst/*.nc and gmst/<scenario>/*.nc)."
            )
        return env
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cand = os.path.join(here, "experiments", "data")
    if os.path.isdir(cand):
        return cand
    raise FileNotFoundError(
        "GMST data directory not found: set BET_DATA_DIR to a directory "
        "containing obs/gmst/*.nc and gmst/<scenario>/*.nc (layout of the "
        "reference's experiments/data)."
    )


_OBS_FILE = "obs/gmst/HadCRUT.5.0.1.0.analysis.anomalies_gmst.nc"


def _model_name(path: str) -> str:
    return "_".join(os.path.basename(path).split("_")[:2])


_OBS_TIME_CACHE: tp.Dict[str, np.ndarray] = {}


def _obs_time(data_dir: str) -> tp.Optional[np.ndarray]:
    """HadCRUT5 time coordinate, parsed once per data directory.

    Every scenario load needs it for the calendar collocation.  Existence is
    re-checked on every call (an observations file created after the first
    lookup must be seen), and the cached vector is read-only so that one
    consumer cannot corrupt every scenario's coordinates."""
    obs_path = os.path.join(data_dir, _OBS_FILE)
    if not os.path.exists(obs_path):
        return None
    cached = _OBS_TIME_CACHE.get(obs_path)
    if cached is None:
        cached = np.asarray(netcdf.open_dataarray(obs_path, name="tas").time)
        cached.setflags(write=False)
        _OBS_TIME_CACHE[obs_path] = cached
    return cached


def load_observations(
    data_dir: tp.Optional[str] = None, resample_freq: tp.Optional[str] = "Y"
) -> ProcessModel:
    """HadCRUT5 GMST anomalies, resampled (annual by default).

    ``resample_freq=None`` keeps the native monthly resolution (T = 1980).
    The result is numpy-backed; the device enters at ``fit``.
    """
    data_dir = data_dir or default_data_dir()
    da = netcdf.open_dataarray(os.path.join(data_dir, _OBS_FILE), name="tas")
    if resample_freq is None:
        return ProcessModel(da, "Observations")
    vals, new_time = timeutils.resample_mean(da.values, da.time, resample_freq, time_axis=1)
    coords = dict(da.coords)
    coords["time"] = new_time
    return ProcessModel(DimArray(vals, da.dims, coords, name=da.name), "Observations")


def load_scenario(
    ssp: str,
    data_dir: tp.Optional[str] = None,
    resample_freq: tp.Optional[str] = "Y",
    collocate_obs_time: bool = True,
) -> tp.Tuple[ModelCollection, ModelCollection]:
    """Load (historical, ssp) anomaly collections for one scenario.

    Only models present in BOTH the historical and the SSP directory are
    kept; historical anomalies define each model's climatology, which is
    then applied to its SSP run.  ``resample_freq`` is any calendar
    frequency of ``io.timeutils.resample_mean`` ('M'/'Q'/'Y'); ``None``
    keeps the native monthly resolution (T = 1980 hist / 1032 SSP).

    ``collocate_obs_time`` reproduces the reference's calendar collocation:
    model calendars differ from HadCRUT5's in day-of-month conventions, so
    a historical model's time axis is overwritten with the observations'
    when the lengths match.  Resampled labels coincide anyway; the native
    monthly resolution needs it for the weighters' time-alignment check.
    """
    data_dir = data_dir or default_data_dir()
    hist_files = {
        _model_name(p): p
        for p in sorted(glob.glob(os.path.join(data_dir, "gmst/historical/*.nc")))
    }
    ssp_files = {
        _model_name(p): p
        for p in sorted(glob.glob(os.path.join(data_dir, f"gmst/{ssp}/*.nc")))
    }
    common = sorted(set(hist_files) & set(ssp_files))
    if not common:
        raise FileNotFoundError(f"no overlapping models for {ssp} under {data_dir}")

    obs_time = _obs_time(data_dir) if collocate_obs_time else None

    hist_models, ssp_models = [], []
    for name in common:
        hist_da = netcdf.open_dataarray(hist_files[name], name="tas")
        if obs_time is not None and hist_da.time.shape == obs_time.shape:
            coords = dict(hist_da.coords)
            coords["time"] = obs_time
            hist_da = DimArray(hist_da.values, hist_da.dims, coords, name=hist_da.name)
        hist_anom = ProcessModel(hist_da, name).calculate_anomaly(resample_freq=resample_freq)
        hist_models.append(hist_anom)

        ssp_da = netcdf.open_dataarray(ssp_files[name], name="tas")
        ssp_models.append(ProcessModel(ssp_da, name).calculate_anomaly(
            climatology=hist_anom.climatology, resample_freq=resample_freq
        ))

    return ModelCollection(hist_models), ModelCollection(ssp_models)


def load_packed_scenarios(
    data_dir: tp.Optional[str] = None,
    resample_freq: tp.Optional[str] = "Y",
    ssps: tp.Optional[tp.Sequence[str]] = None,
):
    """Load EVERY scenario and pack them into one merged batch, padded to a
    common ``(S, M, R, T)`` layout for
    ``parallel.step.ensemble_multi_scenario_step``.

    Returns ``(hb, hm, sb, sm, model_masks, names)``: numpy arrays stacked
    over the scenario axis plus the scenario name tuple.  ``hb/sb`` are the
    zero-padded realisation blocks, ``hm/sm`` the realisation masks, and
    ``model_masks`` zeroes the padded model slots (see
    ``parallel.step.pad_models``).
    """
    names = tuple(ssps) if ssps else ALL_SSPS
    scenarios = [load_scenario(ssp, data_dir, resample_freq=resample_freq) for ssp in names]
    m_max = max(len(h) for h, _ in scenarios)
    r_max = max(max(h.max_realisations, s.max_realisations) for h, s in scenarios)
    packed = []
    for hist, ssp_mc in scenarios:
        hb, hm = hist.padded_stack(r_target=r_max)
        sb, sm = ssp_mc.padded_stack(r_target=r_max)
        hb, hm, mmask = pad_models(hb, hm, m_max)
        sb, sm, _ = pad_models(sb, sm, m_max)
        packed.append((hb, hm, sb, sm, mmask))
    stacked = tuple(np.stack([p[i] for p in packed]) for i in range(5))
    return stacked + (names,)


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
    ``optimizer``: "adam" (reference-faithful default), "bfgs"
    (per-model damped quasi-Newton; use with n_optim_nits ~ 30-60) or
    "lbfgs" (optax's L-BFGS: one line search for each fit's summed NLML).
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
