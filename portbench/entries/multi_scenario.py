"""``ensemble_multi_scenario_step``: every scenario's historical and SSP
collections emulated as one batch each, then the CRPS weights and the W2
barycentre a scenario."""

from __future__ import annotations

from portbench.entries import GP_FIT_SITE, as_tensors, fit_kwargs

OUTPUTS = ("bary_mean", "bary_std", "weights")
_INPUTS = ("hist_blocks", "hist_masks", "ssp_blocks", "ssp_masks", "obs", "model_masks")
TINY = dict(scenarios=2, models=3, min_real_models=2, realisations=5, t_hist=14, t_ssp=9,
            obs_members=6)
# Where faults.py plants: the fit, and the tail.
FIT_SITE = GP_FIT_SITE
TAIL_SITE = ("bayesian_ensembling_tpu_torch.parallel.step", "multi_scenario_tail")


def tensors(inputs, dtype, device):
    """The entry's positional tensors, masks as booleans."""
    return as_tensors(inputs, _INPUTS, dtype, device)


# The jitter ensemble_multi_scenario_step fits at (emulate_marginals' default).
_ENTRY_JITTER = 1e-6


def step(bt, t, config, profile):
    if config["jitter"] != _ENTRY_JITTER:
        raise ValueError(f"ensemble_multi_scenario_step fits at a jitter of {_ENTRY_JITTER}, "
                         f"not the configuration's {config['jitter']}")
    return bt.ensemble_multi_scenario_step(
        *t, kernel_name=config["kernel"], weight_kind=config["weight_kind"],
        sigma_mode=config["sigma_mode"], dba_iterations=profile["dba_iterations"],
        **fit_kwargs(profile))


def collections(config):
    """Two batches, every scenario's models at once: the historical
    collections, then the SSP ones."""
    s = config["shape"]
    b = s["scenarios"] * s["models"]
    return [(b, s["t_hist"], s["realisations"]), (b, s["t_ssp"], s["realisations"])]


def reference(inputs, config, profile, device, dtype):
    """The plain reference's answers of the same step (``portbench/reference``)."""
    from portbench.reference import steps

    return steps.multi_scenario(inputs, config, profile, device, dtype)
