"""``gridded_ensemble_step``: every (model, cell) pair emulated in one batch,
then per cell the CRPS weights and the W2 barycentre."""

from __future__ import annotations

from portbench.entries import GP_FIT_SITE, as_tensors, fit_kwargs

OUTPUTS = ("bary_mean", "bary_std", "weights")
_INPUTS = ("block", "obs", "mask")
TINY = dict(models=3, lat=2, lon=2, realisations=4, t=11, obs_members=5)
# Where faults.py plants: the fit, and the tail.
FIT_SITE = GP_FIT_SITE
TAIL_SITE = ("bayesian_ensembling_tpu_torch.parallel.gridded", "gridded_tail")


def tensors(inputs, dtype, device):
    """The entry's positional tensors ``(block, obs, mask)``, the mask boolean."""
    return as_tensors(inputs, _INPUTS, dtype, device)


def step(bt, t, config, profile):
    return bt.gridded_ensemble_step(
        *t, None, weight_kind=config["weight_kind"], sigma_mode=config["sigma_mode"],
        kernel_name=config["kernel"], jitter=config["jitter"],
        dba_iterations=profile["dba_iterations"], **fit_kwargs(profile))


def collections(config):
    """One batch: every (model, cell) pair."""
    s = config["shape"]
    return [(s["models"] * s["lat"] * s["lon"], s["t"], s["realisations"])]


def reference(inputs, config, profile, device, dtype):
    """The plain reference's answers of the same step (``portbench/reference``)."""
    from portbench.reference import steps

    return steps.gridded(inputs, config, profile, device, dtype)
