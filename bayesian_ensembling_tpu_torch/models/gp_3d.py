"""GPDTW3D: spatiotemporal emulator for (realisation, time, lat, lon) fields.

PyTorch counterpart of ``bayesian_ensembling_tpu/models/gp_3d.py``, two
modes:

  * ``mode="batched"`` (default): every grid cell is an independent DBA +
    exact heteroskedastic GP over its own realisation features, the 1-D
    flagship pipeline (``parallel/step.emulate_marginals``) over the cells
    of one model at a time, ``B = C`` fits a batch;
  * ``mode="svgp"``: one sparse variational GP per model on the reference's
    feature engineering (unit-sphere x, y, z + scaled continuous time +
    realisation columns, additive Matern-3/2 kernels; ``ops/svgp.py``).

Both modes return a diagonal posterior over the flattened
(time, latitude, longitude) points, on the device the fit ran on.
"""

from __future__ import annotations

import typing as tp
import warnings

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import resolve_device
from bayesian_ensembling_tpu_torch.data import ModelCollection, Posterior, ProcessModel
from bayesian_ensembling_tpu_torch.models.base import AbstractEmulator
from bayesian_ensembling_tpu_torch.ops.distributions import DiagGaussian
from bayesian_ensembling_tpu_torch.parallel.step import emulate_marginals

__all__ = ["GPDTW3D", "spherical_time_features"]


def _check_dims(pm: ProcessModel):
    if pm.ndim != 4:
        raise NotImplementedError(
            "GPDTW3D needs exactly (realisation, time, latitude, longitude) data"
        )
    if pm.data.dims[2] != "latitude" or pm.data.dims[3] != "longitude":
        raise IndexError("Coordinate order should be realisation, time, latitude, longitude")


def spherical_time_features(lat: np.ndarray, lon: np.ndarray, n_time: int) -> np.ndarray:
    """Unit-sphere embedding + scaled continuous time, flattened ``(N, 4)``:
    x = cos(lat)cos(lon), y = cos(lat)sin(lon), z = sin(lat), t scaled to
    [-1, 1]; rows in (time, lat, lon) order."""
    lat_r = np.deg2rad(lat)
    lon_r = np.deg2rad(lon)
    lon_g, lat_g = np.meshgrid(lon_r, lat_r)  # (La, Lo)
    x = np.cos(lat_g) * np.cos(lon_g)
    y = np.cos(lat_g) * np.sin(lon_g)
    z = np.sin(lat_g)
    t = np.arange(n_time, dtype=np.float64)
    t = 2.0 * t / max(t.max(), 1.0) - 1.0
    n_cells = x.size
    feats = np.empty((n_time * n_cells, 4))
    sp = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)  # (C, 3)
    feats[:, 0:3] = np.tile(sp, (n_time, 1))
    feats[:, 3] = np.repeat(t, n_cells)
    return feats


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


class GPDTW3D(AbstractEmulator):
    """Spatiotemporal DBA + GP emulator (batched-exact or SVGP mode).

    Defaults come from a typed config (``GPRParameters``, or
    ``SGPRParameters`` in svgp mode); explicit ``fit`` kwargs override it.
    """

    def __init__(
        self,
        name: str = "GP3DRegressor",
        mode: str = "batched",
        kernel: tp.Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        config=None,
    ) -> None:
        super().__init__(name)
        from bayesian_ensembling_tpu_torch.utils.config import GPRParameters, SGPRParameters

        self.config = config or (
            SGPRParameters() if mode == "svgp" else GPRParameters(kernel=kernel or "matern32")
        )
        self.mode = mode
        self.kernel = kernel or getattr(self.config, "kernel", "matern32")
        self.dtype = dtype
        if mode == "svgp":
            warnings.warn(
                "GPDTW3D svgp mode is a joint approximation over all cells "
                "(reference semantics); batched mode is exact per cell."
            )

    def _cell_block(self, pm: ProcessModel, device) -> torch.Tensor:
        """``(R, T, La, Lo)`` -> ``(C, R, T)``: every cell a realisation stack."""
        r, t, la, lo = pm.data.shape
        block = np.transpose(pm.data.values.reshape(r, t, la * lo), (2, 0, 1))
        return torch.as_tensor(block.astype(_np_dtype(self.dtype)), device=device)

    # ----------------------------------------------------------- batched mode
    def _fit_batched(
        self,
        collection: ModelCollection,
        n_optim_nits: int,
        learning_rate: float,
        dba_iterations: int,
        jitter: float,
        dba_method: str,
        dba_tol: tp.Optional[float],
        refine_f64: bool,
        refine_device,
        refine_cell_chunk: tp.Optional[int],
        device: torch.device,
    ) -> tp.List[Posterior]:
        from bayesian_ensembling_tpu_torch.parallel.gridded import refine_marginals_f64

        posts = []
        for pm in collection:  # models may differ in R; the cells batch inside
            block = self._cell_block(pm, device)
            mask = torch.ones(block.shape[:2], dtype=torch.bool, device=device)
            out = emulate_marginals(
                block, mask,
                kernel_name=self.kernel,
                n_optim_nits=n_optim_nits,
                learning_rate=learning_rate,
                dba_iterations=dba_iterations,
                dba_method=dba_method,
                dba_tol=dba_tol,
                jitter=jitter,
                return_params=refine_f64,
                return_targets=refine_f64,
            )  # (C, T) each
            mean, var = out[0], out[1]
            if refine_f64:
                # Published moments in float64 at the converged
                # hyperparameters, from the fit's own targets.
                mean, var = refine_marginals_f64(
                    block, mask, out[2], (out[3], out[4]), kernel_name=self.kernel,
                    jitter=jitter, chunk=refine_cell_chunk,
                    device=device if refine_device is None else refine_device,
                )
            # Back to flattened (time, lat, lon) order for the template.
            posts.append(Posterior(
                gaussian=DiagGaussian(mean=mean.T.reshape(-1), var=var.T.reshape(-1)),
                template=pm.blank_template(),
            ))
        return posts

    # -------------------------------------------------------------- svgp mode
    def _fit_svgp(
        self,
        collection: ModelCollection,
        n_optim_nits: int,
        learning_rate: float,
        dba_iterations: int,
        n_inducing: int,
        minibatch_size: int,
        dba_method: str,
        dba_tol: tp.Optional[float],
        device: torch.device,
    ) -> tp.List[Posterior]:
        from bayesian_ensembling_tpu_torch.ops import dtw as dtw_ops
        from bayesian_ensembling_tpu_torch.ops import svgp as svgp_ops

        posts = []
        for pm in collection:
            r, t, la, lo = pm.data.shape
            c = la * lo
            cell_block = self._cell_block(pm, device)  # (C, R, T)
            ones = torch.ones((c, r), dtype=torch.bool, device=device)
            # Per-cell DBA target, the batched entry point.
            if dba_method == "subgradient":
                y_mean = dtw_ops.dba_subgradient_batch(
                    cell_block, ones, max_iter=dba_iterations,
                    tol=1e-3 if dba_tol is None else dba_tol,
                )
            else:
                y_mean = dtw_ops.dba_batch(cell_block, ones, n_iterations=dba_iterations,
                                           init="medoid", tol=dba_tol)  # (C, T)
            y_var = torch.var(cell_block, dim=1, unbiased=False)  # (C, T)
            y_mean_f = y_mean.T.reshape(-1)  # (T*C,) in (time, cell) order
            y_var_f = torch.clamp(y_var.T.reshape(-1), min=1e-8)

            feats = spherical_time_features(
                pm.data.get_coord("latitude"), pm.data.get_coord("longitude"), t)
            # Realisation columns, one per realisation.
            vals = pm.data.values.astype(_np_dtype(self.dtype))
            real_cols = vals.reshape(r, t * c).T  # (T*C, R)
            x = torch.as_tensor(np.concatenate([feats, real_cols], axis=1)
                                .astype(_np_dtype(self.dtype)), device=device)

            # n_optim_nits "epochs" of N // minibatch_size steps each, the
            # reference's knob semantics.
            n_points = x.shape[0]
            total_steps = n_optim_nits * max(n_points // minibatch_size, 1)
            mean_f, var_f = svgp_ops.fit_predict_svgp(
                x, y_mean_f, y_var_f,
                n_inducing=n_inducing,
                minibatch_size=min(minibatch_size, n_points),
                n_optim_nits=total_steps,
                learning_rate=learning_rate,
            )
            posts.append(Posterior(
                gaussian=DiagGaussian(mean=mean_f, var=var_f + y_var_f),  # + the DTW variance
                template=pm.blank_template(),
            ))
        return posts

    def fit_collection(
        self,
        collection: ModelCollection,
        n_optim_nits: tp.Optional[int] = None,
        learning_rate: tp.Optional[float] = None,
        dba_iterations: tp.Optional[int] = None,
        dba_method: tp.Optional[str] = None,
        dba_tol: tp.Optional[float] = None,
        n_inducing: tp.Optional[int] = None,
        minibatch_size: tp.Optional[int] = None,
        jitter: tp.Optional[float] = None,
        refine_f64: bool = False,
        refine_device: tp.Union[str, torch.device, None] = None,
        refine_cell_chunk: tp.Optional[int] = None,
        device: tp.Union[str, torch.device] = "cuda",
        **_: tp.Any,
    ) -> tp.List[Posterior]:
        """Fit every model on ``device`` (the card unless the caller asks for
        ``"cpu"``; a CUDA device without CUDA raises).  ``refine_f64``
        (batched mode only) publishes float64 moments recomputed on
        ``refine_device`` (``device`` when omitted), the cells in pieces of
        ``refine_cell_chunk``."""
        device = resolve_device(device, "GPDTW3D.fit_collection")
        cfg = self.config
        n_optim_nits = cfg.n_optim_nits if n_optim_nits is None else n_optim_nits
        learning_rate = cfg.learning_rate if learning_rate is None else learning_rate
        dba_iterations = (getattr(cfg, "dba_iterations", 10) if dba_iterations is None
                          else dba_iterations)
        dba_method = getattr(cfg, "dba_method", "classic") if dba_method is None else dba_method
        n_inducing = getattr(cfg, "n_inducing", 400) if n_inducing is None else n_inducing
        minibatch_size = (getattr(cfg, "minibatch_size", 500) if minibatch_size is None
                          else minibatch_size)
        jitter = getattr(cfg, "jitter", 1e-6) if jitter is None else jitter
        for pm in collection:
            _check_dims(pm)
        if self.mode == "batched":
            return self._fit_batched(
                collection, n_optim_nits, learning_rate, dba_iterations, jitter, dba_method,
                dba_tol, refine_f64, refine_device, refine_cell_chunk, device,
            )
        if refine_f64:
            raise ValueError(
                "refine_f64 applies to GPDTW3D batched mode only: the svgp mode's "
                "posterior is a variational approximation, so a float64 re-solve of "
                "its predictive equations would not remove approximation error, just "
                "solve scatter; fit in batched mode for refined moments"
            )
        if self.mode == "svgp":
            return self._fit_svgp(
                collection, n_optim_nits, learning_rate, dba_iterations, n_inducing,
                minibatch_size, dba_method, dba_tol, device,
            )
        raise ValueError(f"unknown mode {self.mode!r}")
