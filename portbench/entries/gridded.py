"""``gridded_ensemble_step``: every (model, cell) pair emulated in one batch,
then per cell the CRPS weights and the W2 barycentre."""

from __future__ import annotations

from portbench.entries import as_tensors, fit_kwargs

OUTPUTS = ("bary_mean", "bary_std", "weights")
_INPUTS = ("block", "obs", "mask")


def tensors(inputs, dtype, device):
    """The entry's positional tensors ``(block, obs, mask)``, the mask boolean."""
    return as_tensors(inputs, _INPUTS, dtype, device)


def step(bt, t, config, profile):
    return bt.gridded_ensemble_step(
        *t, None, weight_kind=config["weight_kind"], sigma_mode=config["sigma_mode"],
        kernel_name=config["kernel"], jitter=config["jitter"],
        dba_iterations=profile["dba_iterations"], **fit_kwargs(profile))


def staged(bt, t, config, profile, span):
    """The step's work as the entry does it, one stage at a time under
    ``span(stage)``: the DBA targets, the fit and the posterior of every
    (model, cell) pair, then the tail."""
    from bayesian_ensembling_tpu_torch.ops import gp as gp_ops
    from bayesian_ensembling_tpu_torch.parallel import gridded as gridded_ops

    block, obs, mask = t
    m, c, r, tt = block.shape
    kernel, jitter = config["kernel"], config["jitter"]
    with span("dba"):
        x, y, noise = gp_ops.prepare_gp_inputs(block.reshape(m * c, r, tt), mask.reshape(m * c, r),
                                               dba_iterations=profile["dba_iterations"])
    with span("fit"):
        params, _ = gp_ops.fit_gp_batch_dispatch(x, y, noise, kernel_name=kernel, jitter=jitter,
                                                 **fit_kwargs(profile))
    with span("posterior"):
        mean, var = gp_ops.posterior_marginals_batch(params, x, y, noise, kernel_name=kernel,
                                                     jitter=jitter)
    with span("tail"):
        return gridded_ops.gridded_tail(mean.reshape(m, c, tt), (var + noise).reshape(m, c, tt),
                                        obs, block, mask, None, weight_kind=config["weight_kind"],
                                        sigma_mode=config["sigma_mode"])


def reference(inputs, config, profile, device, dtype):
    """The plain reference's answers of the same step (``portbench/reference``)."""
    from portbench.reference import steps

    return steps.gridded(inputs, config, profile, device, dtype)
