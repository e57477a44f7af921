"""``ensemble_multi_scenario_step``: every scenario's historical and SSP
collections emulated as one batch each, then the CRPS weights and the W2
barycentre a scenario."""

from __future__ import annotations

from portbench.entries import as_tensors, fit_kwargs

OUTPUTS = ("bary_mean", "bary_std", "weights")
_INPUTS = ("hist_blocks", "hist_masks", "ssp_blocks", "ssp_masks", "obs", "model_masks")


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


def staged(bt, t, config, profile, span):
    """The step's work as the entry does it, one stage at a time under
    ``span(stage)``: for each collection the DBA targets, the fit and the
    posterior, then the tail."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
    from bayesian_ensembling_tpu_torch.parallel import step as step_ops

    hb, hm, sb, sm, obs, mm = t
    s, m, r, _ = hb.shape
    kernel, jitter = config["kernel"], config["jitter"]
    marginals = []
    for block, mask in ((hb, hm), (sb, sm)):
        tt = block.shape[-1]
        with span("dba"):
            x, y, noise = gp_ops.prepare_gp_inputs(block.reshape(s * m, r, tt), mask.reshape(s * m, r),
                                                   dba_iterations=profile["dba_iterations"])
        with span("fit"):
            params, _ = gp_ops.fit_gp_batch_dispatch(x, y, noise, kernel_name=kernel, jitter=jitter,
                                                     **fit_kwargs(profile))
        with span("posterior"):
            mean, var = gp_ops.posterior_marginals_batch(params, x, y, noise, kernel_name=kernel,
                                                         jitter=jitter)
        marginals.append((mean.reshape(s, m, tt), (var + noise).reshape(s, m, tt)))
    (h_mean, h_var), (s_mean, s_var) = marginals
    with span("tail"):
        return step_ops.multi_scenario_tail(h_mean, h_var, s_mean, s_var, obs, hb, hm, mm,
                                            weight_kind=config["weight_kind"],
                                            sigma_mode=config["sigma_mode"])


def reference(inputs, config, profile, device, dtype):
    """The plain reference's answers of the same step (``portbench/reference``)."""
    from portbench.reference import steps

    return steps.multi_scenario(inputs, config, profile, device, dtype)
