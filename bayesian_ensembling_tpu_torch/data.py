"""Data containers: posterior distributions, process models, collections.

PyTorch counterpart of ``bayesian_ensembling_tpu/data.py``.  The containers
are host-side bookkeeping (named dims, time axes, climatology) on numpy
:class:`~bayesian_ensembling_tpu_torch.coords.DimArray` objects; the posterior
moments are tensors, on the device the emulator fitted them on.

Contracts kept from the reference:
  * model data dim 0 is ``realisation``, dim 1 is ``time``;
  * no NaNs allowed in model data;
  * ``ModelCollection`` checks/repairs mismatched time axes with a warning;
  * a fitted emulator attaches a posterior ``distribution`` to each model.

Checkpointing is pickle-free: ``save``/``load`` write and read the JAX
package's npz format, array for array, so a collection saved by either
package loads in the other.  Sampling takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import os
import typing as tp
import warnings

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import not_ported, resolve_device
from bayesian_ensembling_tpu_torch.coords import DimArray
from bayesian_ensembling_tpu_torch.io import timeutils
from bayesian_ensembling_tpu_torch.ops.distributions import (
    DiagGaussian,
    FullCovGaussian,
    GaussianMoments,
)

__all__ = ["Posterior", "ProcessModel", "ModelCollection"]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class Posterior:
    """A learnt Gaussian posterior plus the physical-coordinate template:
    flat moments over all physical points, folded back into labelled
    (time[, lat, lon]) arrays on request."""

    gaussian: GaussianMoments
    template: DimArray  # physical dims, no realisation axis

    @property
    def is_full_cov(self) -> bool:
        return isinstance(self.gaussian, FullCovGaussian)

    def reshape(self, vals, name: tp.Optional[str] = None) -> DimArray:
        if isinstance(vals, torch.Tensor):
            vals = _host(vals)
        vals = np.asarray(vals).reshape(self.template.shape)
        out = self.template.copy(values=vals)
        if name:
            out.name = name
        return out

    @property
    def mean(self) -> DimArray:
        return self.reshape(self.gaussian.mean, "posterior mean")

    @property
    def variance(self) -> DimArray:
        return self.reshape(self.gaussian.variance, "posterior variance")

    @property
    def stddev(self) -> DimArray:
        return self.reshape(torch.sqrt(self.gaussian.variance), "posterior stddev")

    def sample(self, generator: tp.Optional[torch.Generator] = None) -> DimArray:
        """One draw; ``generator`` must live on the moments' device (when
        omitted, a fresh one is seeded from numpy's global stream)."""
        if generator is None:
            generator = torch.Generator(device=self.gaussian.mean.device)
            generator.manual_seed(int(np.random.randint(0, 2**31 - 1)))
        return self.reshape(self.gaussian.sample(generator), "posterior sample")

    def log_prob(self, x) -> torch.Tensor:
        mean = self.gaussian.mean
        return self.gaussian.log_prob(torch.as_tensor(x, dtype=mean.dtype, device=mean.device))

    def plot_temporally(self, **kwargs):
        """Mean +- k sigma bands over time (``plotters.plot_posterior_temporal``)."""
        from bayesian_ensembling_tpu_torch.plotters import plot_posterior_temporal

        return plot_posterior_temporal(self, **kwargs)

    def plot_spatially(self, **kwargs):
        """Time-mean maps of mean and stddev (``plotters.plot_posterior_spatial``)."""
        from bayesian_ensembling_tpu_torch.plotters import plot_posterior_spatial

        return plot_posterior_spatial(self, **kwargs)

    # ------------------------------------------------------------ checkpoint
    def to_arrays(self) -> tp.Dict[str, np.ndarray]:
        d = {"mean": _host(self.gaussian.mean)}
        if self.is_full_cov:
            d["cov"] = _host(self.gaussian.cov)
        else:
            d["var"] = _host(self.gaussian.var)
        return d

    @classmethod
    def from_arrays(
        cls,
        arrays: tp.Mapping[str, np.ndarray],
        template: DimArray,
        device: tp.Union[str, torch.device] = "cuda",
    ) -> "Posterior":
        """A posterior from ``to_arrays()`` output (of either package), its
        moments placed on ``device`` in the arrays' own dtype."""
        device = resolve_device(device, "Posterior.from_arrays")
        # torch.tensor copies: the arrays may be read-only views of an archive.
        mean = torch.tensor(np.asarray(arrays["mean"]), device=device)
        if "cov" in arrays:
            g = FullCovGaussian(mean=mean, cov=torch.tensor(np.asarray(arrays["cov"]), device=device))
        else:
            g = DiagGaussian(mean=mean, var=torch.tensor(np.asarray(arrays["var"]), device=device))
        return cls(gaussian=g, template=template)


@dataclasses.dataclass
class ProcessModel:
    """One climate model's simulation output + (optionally) its emulator
    fit: realisation-first data contract, anomaly/climatology computation,
    realisation stats."""

    data: DimArray
    name: str
    climatology: tp.Optional[np.ndarray] = None
    _posterior: tp.Optional[Posterior] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if not isinstance(self.data, DimArray):
            raise TypeError("ProcessModel data must be a DimArray")
        if self.data.dims[0] != "realisation":
            raise ValueError("dim 0 must be 'realisation'")
        if len(self.data.dims) > 1 and self.data.dims[1] != "time":
            raise ValueError("dim 1 must be 'time'")
        if np.isnan(self.data.values).any():
            raise ValueError("model data must not contain NaN")

    # ------------------------------------------------------------ properties
    @property
    def model_data(self) -> DimArray:  # reference-familiar alias
        return self.data

    @property
    def model_name(self) -> str:
        return self.name

    @property
    def n_realisations(self) -> int:
        return self.data.shape[0]

    @property
    def time(self) -> np.ndarray:
        return self.data.time

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def max_val(self) -> float:
        return float(self.data.values.max())

    @property
    def min_val(self) -> float:
        return float(self.data.values.min())

    @property
    def mean_across_realisations(self) -> DimArray:
        return self.data.mean("realisation")

    @property
    def std_across_realisations(self) -> DimArray:
        return self.data.std("realisation")

    @property
    def distribution(self) -> tp.Optional[Posterior]:
        return self._posterior

    @distribution.setter
    def distribution(self, post: Posterior):
        self._posterior = post

    posterior = distribution  # synonym

    def realisations(self) -> tp.Iterator[DimArray]:
        for r in range(self.n_realisations):
            yield self.data.isel(realisation=r)

    def __len__(self) -> int:
        return self.n_realisations

    def __iter__(self):
        return self.realisations()

    def blank_template(self) -> DimArray:
        """Physical-dims template (NaN-filled) for posterior reshaping."""
        first = self.data.isel(realisation=0)
        return first.copy(values=np.full(first.shape, np.nan))

    def plot(self, **kwargs):
        """Realisations and their mean over time (``plotters.plot_process_model``)."""
        from bayesian_ensembling_tpu_torch.plotters import plot_process_model

        return plot_process_model(self, **kwargs)

    # -------------------------------------------------------------- anomaly
    def calculate_anomaly(
        self,
        climatology_dates: tp.Tuple[str, str] = ("1961-01-01", "1990-12-31"),
        climatology: tp.Optional[np.ndarray] = None,
        resample_freq: tp.Optional[str] = None,
    ) -> "ProcessModel":
        """Anomaly vs a monthly climatology, optional resampling.

        The climatology is the per-month mean over the window and
        realisations; a precomputed 12-month climatology is used instead
        when given; ``resample_freq`` then takes period means at any
        supported pandas-style calendar frequency ('M', 'Q', 'Y' and their
        aliases).
        """
        vals = self.data.values
        time = self.time
        if climatology is None:
            clim = timeutils.monthly_climatology(vals, time, climatology_dates)
        else:
            clim = np.asarray(climatology)
            if clim.shape[0] != 12:
                raise ValueError("climatology must have 12 monthly entries")
        anom = timeutils.apply_climatology(vals, time, clim)
        new_time = time
        if resample_freq:
            anom, new_time = timeutils.resample_mean(anom, time, resample_freq, time_axis=1)
        coords = dict(self.data.coords)
        coords["time"] = new_time
        da = DimArray(anom, self.data.dims, coords, name=self.data.name)
        out = ProcessModel(da, self.name + " anomaly")
        out.climatology = clim
        return out


@dataclasses.dataclass
class ModelCollection:
    """An ordered set of :class:`ProcessModel` objects."""

    models: tp.List[ProcessModel]

    def __post_init__(self):
        if not self.models:
            raise ValueError("ModelCollection needs at least one model")
        self.check_time_axes()

    # ------------------------------------------------------------- protocol
    def __len__(self) -> int:
        return len(self.models)

    def __iter__(self) -> tp.Iterator[ProcessModel]:
        return iter(self.models)

    def __getitem__(self, item: int) -> ProcessModel:
        return self.models[item]

    @property
    def number_of_models(self) -> int:
        return len(self.models)

    @property
    def model_names(self) -> tp.List[str]:
        return [m.name for m in self.models]

    @property
    def time(self) -> np.ndarray:
        return self.models[0].time

    @property
    def max_val(self) -> float:
        return max(m.max_val for m in self.models)

    @property
    def min_val(self) -> float:
        return min(m.min_val for m in self.models)

    @property
    def max_realisations(self) -> int:
        return max(m.n_realisations for m in self.models)

    def distributions(self) -> tp.Dict[str, tp.Optional[Posterior]]:
        return {m.name: m.distribution for m in self.models}

    def check_time_axes(self):
        """Warn + naively repair mismatched time axes.

        The naive repair only makes sense for equal-LENGTH axes (calendar /
        label mismatches); differing lengths cannot be collocated by
        relabelling, so they raise instead.
        """
        t0 = self.models[0].time
        bad_len = [m.name for m in self.models[1:] if len(m.time) != len(t0)]
        if bad_len:
            raise ValueError(
                f"models {bad_len} have different time-axis LENGTHS than "
                f"{self.models[0].name} ({len(t0)} steps); align or resample "
                "the data before building the collection"
            )
        mismatch = any(np.any(m.time != t0) for m in self.models[1:])
        if mismatch:
            warnings.warn(
                "Time axes of models don't match: applying naive fix. Check "
                "models are collocated correctly in time!"
            )
            for m in self.models:
                m.data.coords["time"] = t0

    # ------------------------------------------------------------- batching
    def padded_stack(self, dtype=np.float32, r_target: tp.Optional[int] = None):
        """Stack all models into a padded ``(M, R_max, n_points)`` numpy
        block and its ``(M, R_max)`` validity mask.

        Padding rows are ZERO and flagged False in the mask: mask-aware
        reductions ignore them, and when realisations become GP feature
        *columns* a constant column adds zero to every pairwise distance.
        """
        m = len(self.models)
        r_max = r_target if r_target is not None else self.max_realisations
        if r_max < self.max_realisations:
            raise ValueError("r_target smaller than the largest realisation count")
        flat = [mod.data.values.reshape(mod.n_realisations, -1) for mod in self.models]
        n_points = flat[0].shape[1]
        out = np.zeros((m, r_max, n_points), dtype=dtype)
        mask = np.zeros((m, r_max), dtype=bool)
        for i, f in enumerate(flat):
            r = f.shape[0]
            out[i, :r] = f
            mask[i, :r] = True
        return out, mask

    def fit(self, model, **kwargs):
        """Emulate every member.  An emulator with ``fit_collection`` fits
        the whole collection as one batch (on ``device="cuda"`` unless the
        caller passes another); otherwise each model is fitted in turn."""
        for pm in self.models:
            if pm.distribution is not None:
                warnings.warn("Removing the model's previously learnt distribution")
        if hasattr(model, "fit_collection"):
            posts = model.fit_collection(self, **kwargs)
            for pm, post in zip(self.models, posts):
                pm.distribution = post
        else:
            for pm in self.models:
                pm.distribution = model.fit(pm, **kwargs)

    # --------------------------------------------------------------- plots
    def plot_all(self, **kwargs):
        """All model means on one axes (``plotters.plot_collection``)."""
        from bayesian_ensembling_tpu_torch.plotters import plot_collection

        return plot_collection(self, **kwargs)

    def plot_grid(self, **kwargs):
        """One panel per model (``plotters.plot_collection_grid``)."""
        from bayesian_ensembling_tpu_torch.plotters import plot_collection_grid

        return plot_collection_grid(self, **kwargs)

    # ----------------------------------------------------------- checkpoint
    def _to_blobs(self) -> tp.Dict[str, np.ndarray]:
        """Flat array dict (strings as fixed-width unicode: no object
        arrays, so no pickle anywhere in the format)."""
        blobs: tp.Dict[str, np.ndarray] = {
            "__names__": np.array(self.model_names, dtype=np.str_)
        }
        for i, m in enumerate(self.models):
            blobs[f"m{i}/data"] = m.data.values
            blobs[f"m{i}/dims"] = np.array(m.data.dims, dtype=np.str_)
            for d, c in m.data.coords.items():
                blobs[f"m{i}/coord/{d}"] = c
            if m.climatology is not None:
                blobs[f"m{i}/climatology"] = m.climatology
            if m.distribution is not None:
                for k, v in m.distribution.to_arrays().items():
                    blobs[f"m{i}/post/{k}"] = v
        return blobs

    @classmethod
    def _from_blobs(cls, z, files, device="cuda") -> "ModelCollection":
        names = [str(n) for n in np.asarray(z["__names__"])]
        models = []
        for i, name in enumerate(names):
            dims = tuple(str(d) for d in np.asarray(z[f"m{i}/dims"]))
            coords = {}
            for key in files:
                pre = f"m{i}/coord/"
                if key.startswith(pre):
                    coords[key[len(pre):]] = np.asarray(z[key])
            da = DimArray(np.asarray(z[f"m{i}/data"]), dims, coords)
            pm = ProcessModel(da, name)
            if f"m{i}/climatology" in files:
                pm.climatology = np.asarray(z[f"m{i}/climatology"])
            post_keys = {
                key.split("/")[-1]: np.asarray(z[key])
                for key in files
                if key.startswith(f"m{i}/post/")
            }
            if post_keys:
                pm.distribution = Posterior.from_arrays(post_keys, pm.blank_template(),
                                                        device=device)
            models.append(pm)
        return cls(models)

    def save(self, path: str, backend: str = "npz"):
        """Pickle-free checkpoint of the collection (data, climatology and
        fitted posteriors) as one compressed npz archive, in the JAX
        package's format."""
        if backend == "npz":
            np.savez_compressed(path, **self._to_blobs())
        elif backend == "orbax":
            raise not_ported("ModelCollection.save(backend='orbax')", "A7b-2")
        else:
            raise ValueError(f"unknown checkpoint backend {backend!r}")

    @classmethod
    def load(cls, path: str, device: tp.Union[str, torch.device] = "cuda") -> "ModelCollection":
        """Load an npz checkpoint written by either package; fitted
        posteriors' moments are placed on ``device``."""
        if os.path.isdir(path):  # orbax checkpoints are directories
            raise not_ported("ModelCollection.load of an orbax checkpoint directory", "A7b-2")
        # np.savez_compressed appends '.npz' to extensionless paths: accept
        # the same spelling the caller used with save().
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path, allow_pickle=False) as z:
            return cls._from_blobs(z, z.files, device=device)
