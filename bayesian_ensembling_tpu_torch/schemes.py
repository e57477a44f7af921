"""Ensemble combination schemes: W2 barycentre, multi-model means.

PyTorch counterpart of ``bayesian_ensembling_tpu/schemes.py``.  The whole
barycentre is one batched closed form (or one batched fixed-point loop) over
all points, ``ops.wasserstein.batched_gaussian_barycentre``, the same
function the fused step's tail uses; it runs on the device the posterior
moments are on.
"""

from __future__ import annotations

import abc
import typing as tp
import warnings

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import resolve_device
from bayesian_ensembling_tpu_torch.coords import DimArray
from bayesian_ensembling_tpu_torch.data import ModelCollection, Posterior
from bayesian_ensembling_tpu_torch.ops.distributions import DiagGaussian
from bayesian_ensembling_tpu_torch.ops.wasserstein import batched_gaussian_barycentre

__all__ = [
    "AbstractEnsembleScheme",
    "Barycentre",
    "MultiModelMean",
    "WeightedModelMean",
]


class AbstractEnsembleScheme(abc.ABC):
    """Dispatch shell."""

    def __init__(self, name: str) -> None:
        self.name = name

    @abc.abstractmethod
    def _compute(
        self, process_models: ModelCollection, weights: tp.Optional[DimArray], **kwargs
    ) -> Posterior:
        ...

    def __call__(
        self,
        process_models: ModelCollection,
        weights: tp.Optional[DimArray] = None,
        **kwargs,
    ) -> Posterior:
        self.posterior = self._compute(process_models, weights, **kwargs)
        return self.posterior

    def plot(self, ax=None, x=None):
        """Mean +- 1 sigma band of the last computed ensemble posterior."""
        if getattr(self, "posterior", None) is None:
            raise AttributeError(
                f"{self.name} has no posterior yet — call the scheme first."
            )
        import matplotlib.pyplot as plt

        post = self.posterior
        if ax is None:
            _, ax = plt.subplots(figsize=(12, 5))
        mean = post.mean.values.ravel()
        std = post.stddev.values.ravel()
        if x is None:
            time = post.template.coords.get("time") if post.template is not None else None
            x = np.asarray(time) if time is not None else np.arange(mean.size)
        ax.plot(x, mean, label="Ensemble mean", color="tab:blue")
        ax.fill_between(
            x,
            mean - std,
            mean + std,
            label="Ensemble one sigma",
            color="tab:blue",
            alpha=0.2,
        )
        return ax


def _weights_block(collection: ModelCollection, weights: DimArray) -> np.ndarray:
    """Weights as an (M, n_points) block aligned with the flattened posterior."""
    w = weights.values.reshape(len(collection), -1)
    n_points = collection[0].blank_template().size
    if w.shape[1] == n_points:
        return w
    if w.shape[1] == 1:  # single weight per model, broadcast over points
        return np.broadcast_to(w, (len(collection), n_points))
    raise ValueError(
        f"weights shape {weights.shape} incompatible with {n_points} points"
    )


def _moments_posterior(mean: np.ndarray, var: np.ndarray, collection: ModelCollection,
                       who: str) -> Posterior:
    """Moments computed on the host, placed where the collection's fitted
    posteriors are and in their dtype (as the JAX package holds host
    moments in its default float dtype); an unfitted collection's go to the
    card in the data's dtype (without CUDA that raises: nothing falls back
    to the CPU on its own)."""
    fitted = [pm.distribution for pm in collection if pm.distribution is not None]
    if fitted:
        like = fitted[0].gaussian.mean
        device, dtype = like.device, like.dtype
    else:
        device, dtype = resolve_device("cuda", who), None
    g = DiagGaussian(mean=torch.as_tensor(mean, dtype=dtype, device=device),
                     var=torch.as_tensor(var, dtype=dtype, device=device))
    return Posterior(gaussian=g, template=collection[0].blank_template())


class Barycentre(AbstractEnsembleScheme):
    """Pointwise Gaussian combination of the fitted posteriors.

    Three sigma modes (the mean is always ``sum w_i mu_i``; see
    ``ops.wasserstein.batched_gaussian_barycentre``):
      * ``sigma_mode="w2"`` (default): closed-form W2 barycentre
        ``sigma = sum_i w_i sigma_i``;
      * ``sigma_mode="compat"`` (or ``compat_fixed_point=True``): the
        reference-faithful fixed-point iteration including its signed
        convergence test;
      * ``sigma_mode="mixture"``: moment-matched mixture variance
        ``sigma^2 = sum w_i (sigma_i^2 + (mu_i - mu)^2)``, the calibrated
        option (adds the inter-model spread the W2 barycentre drops).
    """

    def __init__(self, name: str = "Barycentre") -> None:
        super().__init__(name)

    def _compute(
        self,
        process_models: ModelCollection,
        weights: DimArray,
        compat_fixed_point: bool = False,
        sigma_mode: str = "w2",
    ) -> Posterior:
        for pm in process_models:
            if pm.distribution is None:
                raise AttributeError(
                    f"No posterior for model {pm.name}. Please run fit() first."
                )
        means = torch.stack([pm.distribution.gaussian.mean for pm in process_models])
        stds = torch.stack(
            [torch.sqrt(pm.distribution.gaussian.variance) for pm in process_models]
        )
        w = torch.as_tensor(np.ascontiguousarray(_weights_block(process_models, weights)),
                            dtype=means.dtype, device=means.device)
        if compat_fixed_point:
            sigma_mode = "compat"
        if sigma_mode == "compat":
            mu, sigma, n_iters = batched_gaussian_barycentre(means, stds, w, sigma_mode="compat")
            n_bad = int(torch.sum(n_iters > 200))
            if n_bad:
                warnings.warn(
                    f"Barycentre not converged for {n_bad} point(s) "
                    "(fixed-point cap reached)"
                )
        else:
            mu, sigma = batched_gaussian_barycentre(means, stds, w, sigma_mode=sigma_mode)
        template = process_models[0].blank_template()
        return Posterior(
            gaussian=DiagGaussian(mean=mu, var=torch.square(sigma)), template=template
        )


class MultiModelMean(AbstractEnsembleScheme):
    """Pooled mean/std of all realisations from all models (host arithmetic
    on the data; the moments are placed on the device of the collection's
    fitted posteriors, on the card when it has none)."""

    def __init__(self, name: str = "MultiModelMean") -> None:
        super().__init__(name)

    def _compute(self, process_models: ModelCollection, weights=None) -> Posterior:
        pooled = np.concatenate(
            [pm.data.values.reshape(pm.n_realisations, -1) for pm in process_models],
            axis=0,
        )
        return _moments_posterior(pooled.mean(axis=0), pooled.std(axis=0) ** 2,
                                  process_models, self.name)


class WeightedModelMean(AbstractEnsembleScheme):
    """Weighted mean of realisation statistics: ``mu = sum w_i mu_i``,
    ``var = sum w_i^2 var_i`` (host arithmetic on the data; the moments are
    placed as :class:`MultiModelMean` places them)."""

    def __init__(self, name: str = "WeightedModelMean") -> None:
        super().__init__(name)

    def _compute(self, process_models: ModelCollection, weights: DimArray) -> Posterior:
        w = _weights_block(process_models, weights)
        mus = np.stack(
            [pm.mean_across_realisations.values.ravel() for pm in process_models]
        )
        varis = np.stack(
            [pm.std_across_realisations.values.ravel() ** 2 for pm in process_models]
        )
        return _moments_posterior((w * mus).sum(axis=0), (w**2 * varis).sum(axis=0),
                                  process_models, self.name)
