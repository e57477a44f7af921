"""Mean-field Gaussian emulator.

PyTorch counterpart of ``bayesian_ensembling_tpu/models/mean_field.py``: an
independent Gaussian per physical point, fitted by maximum likelihood to
the realisation set.

  * the Gaussian MLE has a closed form (sample mean / variance), which is
    also where the reference's 500-step Adam loop converges, so the default
    path is closed-form;
  * the optional Adam refinement (``n_optim_nits > 0``) optimises a
    ``N(mu, softplus(raw_scale)^2)`` log-likelihood batched over ALL models
    at once, on the port's optax-order Adam;
  * padded realisations are masked out of the likelihood.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from bayesian_ensembling_tpu_torch._errors import resolve_device
from bayesian_ensembling_tpu_torch.data import ModelCollection, Posterior
from bayesian_ensembling_tpu_torch.models.base import AbstractEmulator
from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
from bayesian_ensembling_tpu_torch.ops.distributions import DiagGaussian
from bayesian_ensembling_tpu_torch.utils.config import Parameters

__all__ = ["MeanField", "MeanFieldApproximation"]

_LOG_2PI = 1.8378770664093453


def _refine_batch(
    block: torch.Tensor,  # (M, R, N) zero-padded realisations
    mask: torch.Tensor,  # (M, R)
    mean0: torch.Tensor,  # (M, N)
    var0: torch.Tensor,  # (M, N)
    n_optim_nits: int,
    learning_rate: float,
):
    """Adam MLE refinement of all models' mean-field parameters at once.
    Returns ``(mean, var, losses (n_optim_nits,))``."""
    mean = mean0.clone().requires_grad_(True)
    raw_scale = torch.log(torch.expm1(torch.sqrt(torch.clamp(var0, min=1e-12))))
    raw_scale.requires_grad_(True)
    w = mask.to(block.dtype)[:, :, None]  # (M, R, 1)
    leaves = [mean, raw_scale]
    opt = gp_ops._Adam(leaves, learning_rate)
    losses = torch.empty((n_optim_nits,), dtype=block.dtype, device=block.device)
    for it in range(n_optim_nits):
        scale = gp_ops.softplus(raw_scale)
        z2 = torch.square((block - mean[:, None, :]) / scale[:, None, :])
        ll = -0.5 * (z2 + 2.0 * torch.log(scale[:, None, :]) + _LOG_2PI)
        loss = -torch.sum(ll * w)
        grads = torch.autograd.grad(loss, leaves)
        opt.step(leaves, grads)
        losses[it] = loss.detach()
    return mean.detach(), torch.square(gp_ops.softplus(raw_scale.detach())), losses


def _masked_moments(block: np.ndarray, mask: np.ndarray):
    w = mask.astype(block.dtype)[:, :, None]
    n = np.maximum(w.sum(axis=1), 1.0)
    mean = (block * w).sum(axis=1) / n
    var = (np.square(block - mean[:, None, :]) * w).sum(axis=1) / n
    # Variance floor: a single-realisation member has var == 0 exactly,
    # which turns every sigma-dividing weighter (CRPS, log-lik) into NaN for
    # the WHOLE collection after the sum-to-one normalisation.  Same floor
    # as the fused pipeline (ops/gp.prepare_gp_inputs).
    return mean, np.maximum(var, 1e-8)


class MeanField(AbstractEmulator):
    """Mean-field Gaussian emulator (reference ``MeanFieldApproximation``)."""

    def __init__(self, name: str = "MeanFieldModel", dtype: torch.dtype = torch.float32,
                 config: tp.Optional[Parameters] = None) -> None:
        super().__init__(name)
        # Closed-form MLE is exact, so the refinement default is 0 steps.
        self.config = config or Parameters(n_optim_nits=0)
        self.dtype = dtype

    def fit_collection(
        self,
        collection: ModelCollection,
        n_optim_nits: tp.Optional[int] = None,
        learning_rate: tp.Optional[float] = None,
        device: tp.Union[str, torch.device] = "cuda",
        **_: tp.Any,
    ) -> tp.List[Posterior]:
        device = resolve_device(device, "MeanField.fit_collection")
        if n_optim_nits is None:
            n_optim_nits = self.config.n_optim_nits
        if learning_rate is None:
            learning_rate = self.config.learning_rate
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        block, mask = collection.padded_stack(dtype=np_dtype)
        mean, var = _masked_moments(block, mask)
        mean, var = torch.as_tensor(mean, device=device), torch.as_tensor(var, device=device)
        if n_optim_nits > 0:
            mean, var, _ = _refine_batch(
                torch.as_tensor(block, device=device), torch.as_tensor(mask, device=device),
                mean, var, n_optim_nits, learning_rate,
            )
        return [
            Posterior(gaussian=DiagGaussian(mean=mean[i], var=var[i]), template=pm.blank_template())
            for i, pm in enumerate(collection)
        ]


MeanFieldApproximation = MeanField  # reference-familiar alias
