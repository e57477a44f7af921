"""Model weighting: log-likelihood, inverse-square, uniform, similarity, KSD, CRPS.

PyTorch counterpart of ``bayesian_ensembling_tpu/weights.py`` (all of the
reference's weighters): each weight is one vectorised scoring expression
over a ``(n_models, n_points)`` block.  The only cross-model coupling is the
final sum-to-one normalisation over the model axis.

The weighters that score posteriors (log-likelihood, KSD, CRPS, and the
similarity weight's ``single`` mode) compute on the device the collection's
posterior moments are on, i.e. where the emulator fitted them (the card
unless the caller asked for the CPU).  Host arithmetic in numpy, as in the
JAX package: :class:`InverseSquareWeight` (it reads the data, not the
posteriors), :class:`UniformWeight`, and the ``temporal`` / ``spatial``
modes of :class:`ModelSimilarityWeight`, which pull the moments to the host
for the pairwise reduction.  All return numpy-backed ``DimArray`` weights.  On
full-covariance posteriors (``GPDTW1D``) :class:`LogLikelihoodWeight`
factors all the models' covariances with one launch of the Cholesky kernel
and solves against the factors with the vector-solve kernel.

Reference quirks and how they are handled (the JAX package's choices):
  * KSD/CRPS build ``Normal(mean, variance)``, passing the *variance* where
    a scale belongs.  The default here is the correct stddev;
    ``compat_variance_as_scale=True`` reproduces the reference.
  * The full-covariance branch of LogLikelihoodWeight scores the constant
    vector ``obs_t * ones(T)`` per time step (a broadcasting artefact of
    the reference).  The weights depend on it, so it is the default (see
    ``ops.scoring.fullcov_constant_vector_log_likelihood``).
  * ModelSimilarityWeight's W2 uses the un-squared mean gap; kept as the
    default via ``ops.wasserstein``.
"""

from __future__ import annotations

import abc
import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch.coords import DimArray
from bayesian_ensembling_tpu_torch.data import ModelCollection, ProcessModel
from bayesian_ensembling_tpu_torch.ops import linalg_cuda, scoring
from bayesian_ensembling_tpu_torch.ops import wasserstein as ws
from bayesian_ensembling_tpu_torch.ops.distributions import FullCovGaussian

__all__ = [
    "AbstractWeight",
    "LogLikelihoodWeight",
    "InverseSquareWeight",
    "UniformWeight",
    "ModelSimilarityWeight",
    "KSDWeight",
    "CRPSWeight",
]

_LOG_2PI = 1.8378770664093453
_CHOL_JITTER = 1e-10  # FullCovGaussian.chol's default


# --------------------------------------------------------------------- utils
def _posterior_moments(collection: ModelCollection):
    """Stacked posterior marginals: means ``(M, N)``, variances ``(M, N)``."""
    means = torch.stack([m.distribution.gaussian.mean for m in collection])
    varis = torch.stack([m.distribution.gaussian.variance for m in collection])
    return means, varis


def _obs_flat(observations: ProcessModel, like: torch.Tensor) -> torch.Tensor:
    v = observations.data.values.reshape(observations.n_realisations, -1)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _model_coord(collection: ModelCollection) -> np.ndarray:
    """Model-name coordinate as fixed-width unicode (``np.str_``), the dtype
    the checkpoint format uses for names, so coords round-trip."""
    return np.array(collection.model_names, dtype=np.str_)


def _wrap(collection: ModelCollection, values: np.ndarray, name: str) -> DimArray:
    """Fold per-model flat weights back into a ('model', *physical) DimArray."""
    template = collection[0].blank_template()
    m = len(collection)
    vals = np.asarray(values).reshape((m,) + template.shape)
    dims = ("model",) + template.dims
    coords = {k: v for k, v in template.coords.items()}
    coords["model"] = _model_coord(collection)
    return DimArray(vals, dims, coords, name=name)


def _normalise_over_models(w: np.ndarray) -> np.ndarray:
    return w / w.sum(axis=0, keepdims=True)


class AbstractWeight(abc.ABC):
    """Validation + dispatch shell."""

    def __init__(self, name: str) -> None:
        self.name = name

    @abc.abstractmethod
    def _compute(
        self, process_models: ModelCollection, observations: tp.Optional[ProcessModel], **kwargs
    ) -> DimArray:
        ...

    def __call__(
        self,
        process_models: ModelCollection,
        observations: tp.Optional[ProcessModel] = None,
        **kwargs,
    ) -> DimArray:
        if observations is not None:
            if len(process_models.time) != len(observations.time) or np.any(
                process_models.time != observations.time
            ):
                raise ValueError(
                    "Time coordinates do not match between models and observations"
                )
        if self._needs_posteriors():
            for pm in process_models:
                if pm.distribution is None:
                    raise ValueError("Distribution not defined - fit models first")
        return self._compute(process_models, observations, **kwargs)

    def _needs_posteriors(self) -> bool:
        return True


class LogLikelihoodWeight(AbstractWeight):
    """exp(c * mean-over-obs log-likelihood), normalised over models."""

    def __init__(self, name: str = "LogLikelihoodWeight") -> None:
        super().__init__(name)

    def _compute(
        self,
        process_models: ModelCollection,
        observations: ProcessModel,
        return_lls: bool = False,
        standardisation_scheme=torch.exp,
        standardisation_constant: float = 1.0,
        joint: bool = False,
        account_obs_uncertainty: bool = False,
    ) -> DimArray:
        """``joint=True`` scores the *textbook* joint MVN log-likelihood of
        each observation trajectory under the full posterior (one weight per
        model, broadcast over points) instead of the reference's per-point
        constant-vector semantics.  ``account_obs_uncertainty`` inflates the
        posterior (co)variance by the observation ensemble's per-point
        variance before scoring."""
        means, varis = _posterior_moments(process_models)
        obs = _obs_flat(observations, means)
        obs_var = torch.var(obs, dim=0, unbiased=False) if account_obs_uncertainty else None
        if obs_var is not None:
            varis = varis + obs_var[None, :]

        gaussians = [pm.distribution.gaussian for pm in process_models]
        full = [i for i, g in enumerate(gaussians) if isinstance(g, FullCovGaussian)]
        diag = [i for i in range(len(gaussians)) if i not in full]
        lls_mean = torch.empty_like(means)  # (M, N), mean over obs realisations
        if full:
            lls_mean[full] = self._full_cov_lls(
                means[full], torch.stack([gaussians[i].cov for i in full]), obs, obs_var, joint
            )
        if diag:
            ll = scoring.diag_log_likelihood(means[diag][:, None, :], varis[diag][:, None, :], obs)
            if joint:
                ll_r = torch.sum(ll, dim=2)  # (M_diag, R_obs)
                lls_mean[diag] = torch.mean(ll_r, dim=1)[:, None].expand(-1, means.shape[1])
            else:
                lls_mean[diag] = torch.mean(ll, dim=1)

        scaled = standardisation_constant * lls_mean
        if standardisation_scheme is torch.exp:
            # exp(ll)/sum exp(ll) == softmax(ll): subtract the per-point max
            # so float32 never underflows (T=165 MVN log-liks are O(-100);
            # naive exp gives all-zero weights -> NaN after normalisation).
            weights = _host(torch.softmax(scaled, dim=0))
        else:
            weights = _normalise_over_models(_host(standardisation_scheme(scaled)))
        out = _wrap(process_models, weights, "Log-likelihood weights")
        if return_lls:
            # The *raw* log-likelihoods, as the reference's docstring promises.
            return out, _wrap(process_models, _host(lls_mean), "Log-likelihoods")
        return out

    @staticmethod
    def _full_cov_lls(mean, cov, obs, obs_var, joint) -> torch.Tensor:
        """Mean-over-observations log-likelihood ``(M, T)`` of the
        full-covariance models: one factorisation of all covariances (the
        Cholesky kernel within its cap), then the vector-solve kernel for
        the constant-vector scores, or a matrix-right-hand-side solve for
        the joint ones."""
        t = mean.shape[-1]
        if obs_var is not None:
            # Error-in-observations: inflate the posterior covariance by the
            # obs-ensemble variance diagonal before scoring.
            cov = cov + torch.diag(obs_var)
        eye = torch.eye(t, dtype=cov.dtype, device=cov.device)
        chol = linalg_cuda.chol_routed((cov + _CHOL_JITTER * eye).contiguous())
        if not joint:
            return torch.mean(scoring.fullcov_constant_vector_log_likelihood(mean, chol, obs),
                              dim=1)
        # log N(obs_r; mu, Sigma) per obs realisation, averaged over
        # realisations, broadcast constant over points so the output keeps
        # the usual (model, *points) shape.
        diff = obs[None, :, :] - mean[:, None, :]  # (M, R_obs, T)
        z = torch.linalg.solve_triangular(chol, diff.mT, upper=False)  # (M, T, R_obs)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        ll_r = -0.5 * (torch.sum(z * z, dim=1) + logdet[:, None] + t * _LOG_2PI)
        return torch.mean(ll_r, dim=1)[:, None].expand(-1, t)


class InverseSquareWeight(AbstractWeight):
    """(model_mean - obs_mean)^-2, normalised."""

    def __init__(self, name: str = "InverseSquareWeight") -> None:
        super().__init__(name)

    def _needs_posteriors(self) -> bool:
        return False

    def _compute(self, process_models: ModelCollection, observations: ProcessModel) -> DimArray:
        obs_mean = observations.mean_across_realisations.values.ravel()
        w = np.stack(
            [
                (m.mean_across_realisations.values.ravel() - obs_mean) ** -2.0
                for m in process_models
            ]
        )
        return _wrap(process_models, _normalise_over_models(w), "Inverse square weights")


class UniformWeight(AbstractWeight):
    """Constant 1/n_models."""

    def __init__(self, name: str = "UniformWeight") -> None:
        super().__init__(name)

    def _needs_posteriors(self) -> bool:
        return False

    def _compute(
        self, process_models: ModelCollection, observations: tp.Optional[ProcessModel] = None
    ) -> DimArray:
        m = len(process_models)
        n = process_models[0].blank_template().size
        w = np.full((m, n), 1.0 / m)
        return _wrap(process_models, w, "Uniform weights")


class ModelSimilarityWeight(AbstractWeight):
    """Inter-model W2 dissimilarity weights.

    Three modes, all computed as one vectorised pairwise reduction:
      * ``single``: one weight per model from whole-posterior W2
        (full covariance when available);
      * ``temporal``: per time step, W2 over the remaining (spatial) axes;
      * ``spatial``: per grid cell, W2 over the time axis.
    The pair matrix mean over j (diagonal zeros included, matching the
    reference's nanmean over a zero diagonal) is normalised over models, so
    *dissimilar* models get larger weights.
    """

    def __init__(self, name: str = "ModelSimilarityWeight") -> None:
        super().__init__(name)

    def _compute(
        self,
        process_models: ModelCollection,
        observations: tp.Optional[ProcessModel] = None,
        mode: str = "single",
    ) -> DimArray:
        if len(process_models) < 2:
            # The self-dissimilarity vector is identically zero, so the
            # sum-to-one normalisation would be 0/0 = NaN: fail loudly.
            raise ValueError(
                "ModelSimilarityWeight needs at least 2 models (a single "
                "model has zero dissimilarity to itself -> 0/0 weights)"
            )
        means, varis = _posterior_moments(process_models)

        if mode == "single":
            # One whole-series weight per model: a dimensionless ('model',)
            # result.  The combination schemes broadcast it over the
            # physical points (schemes._weights_block).
            vec = self._single(process_models, means, varis)
            vec = vec / vec.sum()
            coords = {"model": _model_coord(process_models)}
            return DimArray(vec, ("model",), coords, name="Model similarity weights")

        template = process_models[0].blank_template()
        phys = template.dims  # e.g. ('time',) or ('time','latitude','longitude')
        shaped_mean = _host(means).reshape((len(process_models),) + template.shape)
        shaped_var = _host(varis).reshape((len(process_models),) + template.shape)

        if mode == "temporal":
            # Collapse all non-time physical axes per timestep.
            event_axes = tuple(range(2, shaped_mean.ndim))  # after (model, time)
            w = _pairwise_w2_reduce(shaped_mean, shaped_var, event_axes)
            dims = ("model", "time")
            coords = {"model": _model_coord(process_models),
                      "time": template.get_coord("time")}
            return DimArray(
                _normalise_over_models(w), dims, coords, name="Model similarity weights"
            )

        if mode == "spatial":
            if "latitude" not in phys or "longitude" not in phys:
                raise ValueError("spatial mode needs latitude/longitude dims")
            t_ax = 1 + phys.index("time")
            w = _pairwise_w2_reduce(shaped_mean, shaped_var, (t_ax,))
            dims = ("model",) + tuple(d for d in phys if d != "time")
            coords = {
                d: template.get_coord(d) for d in phys if d != "time" and d in template.coords
            }
            coords["model"] = _model_coord(process_models)
            return DimArray(
                _normalise_over_models(w), dims, coords, name="Model similarity weights"
            )

        raise ValueError('Mode must be "single", "spatial", or "temporal"')

    @staticmethod
    def _single(process_models, means, varis) -> np.ndarray:
        full = all(
            isinstance(m.distribution.gaussian, FullCovGaussian) for m in process_models
        )
        if full:
            covs = torch.stack([m.distribution.gaussian.cov for m in process_models])
            pair = ws.gaussian_w2_distance(means[:, None], covs[:, None], means[None], covs[None])
        else:
            pair = ws.gaussian_w2_distance_diag(
                means[:, None], varis[:, None], means[None], varis[None]
            )
        return _host(torch.mean(pair, dim=1))


class KSDWeight(AbstractWeight):
    """1 / Kernel-Stein-Discrepancy weights."""

    def __init__(self, name: str = "KernelSteinDiscrepancyWeight") -> None:
        super().__init__(name)

    def _compute(
        self,
        process_models: ModelCollection,
        observations: ProcessModel,
        compat_variance_as_scale: bool = False,
    ) -> DimArray:
        means, varis = _posterior_moments(process_models)
        obs = _obs_flat(observations, means)
        scale = varis if compat_variance_as_scale else torch.sqrt(varis)
        ksd = scoring.batched_imq_ksd(means, scale, obs)  # (M, N)
        return _wrap(
            process_models,
            _normalise_over_models(1.0 / _host(ksd)),
            "Kernel Stein Discrepancy weights",
        )


class CRPSWeight(AbstractWeight):
    """1 / CRPS weights with the closed-form Gaussian CRPS."""

    def __init__(self, name: str = "ContinuousRankedProbabilityScoreWeight") -> None:
        super().__init__(name)

    def _compute(
        self,
        process_models: ModelCollection,
        observations: ProcessModel,
        compat_variance_as_scale: bool = False,
        account_obs_uncertainty: bool = False,
    ) -> DimArray:
        """``account_obs_uncertainty=True`` scores against
        ``N(mu, var + var_obs)`` where ``var_obs`` is the per-point variance
        of the observation ensemble (e.g. HadCRUT5's 200 members), so that
        models are not penalised for disagreement within observational
        spread."""
        means, varis = _posterior_moments(process_models)
        obs = _obs_flat(observations, means)
        if account_obs_uncertainty:
            varis = varis + torch.var(obs, dim=0, unbiased=False)[None, :]
        sigma = varis if compat_variance_as_scale else torch.sqrt(varis)
        crps = scoring.mean_gaussian_crps(means, sigma, obs)  # (M, N)
        return _wrap(
            process_models,
            _normalise_over_models(1.0 / _host(crps)),
            "Continuous Ranked Probability Scores weights",
        )


def _pairwise_w2_reduce(mean: np.ndarray, var: np.ndarray, event_axes: tp.Tuple[int, ...]):
    """Mean-over-j of pairwise W2 with the event axes collapsed.

    mean/var: (M, *phys).  Computes, for each kept index,
    ``|mu_i - mu_j|_2 (over event axes) + sum (sqrt v_i - sqrt v_j)^2`` and
    averages over j (reference semantics incl. un-squared mean norm).
    """
    mu_i = np.expand_dims(mean, 1)
    mu_j = np.expand_dims(mean, 0)
    s_i = np.sqrt(np.clip(np.expand_dims(var, 1), 0.0, None))
    s_j = np.sqrt(np.clip(np.expand_dims(var, 0), 0.0, None))
    axes = tuple(a + 1 for a in event_axes)  # account for the j axis at 1
    if axes:
        loc = np.sqrt(np.sum((mu_i - mu_j) ** 2, axis=axes))
        cov = np.sum((s_i - s_j) ** 2, axis=axes)
    else:
        loc = np.abs(mu_i - mu_j)
        cov = (s_i - s_j) ** 2
    return (loc + cov).mean(axis=1)
