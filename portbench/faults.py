"""Faults planted in the port where a step's answers are made.

A check that a broken timed path comes out not correct plants one of these
under a run: ``portbench/tests/test_portbench_faults.py`` at a tiny size on
the CPU, and ``control.py --fault <name>`` at a cell's own size on the card.
Each is a context manager that swaps one function of the port for the
broken one and puts it back after.

* ``unchanged_fit``: the fit returns its starting state unchanged.
* ``half_first_batch_unfitted``, ``half_last_batch_unfitted``: the second
  half of the step's first or last fit batch (the historical or the SSP
  collection of the annual step; the grid's one batch of the gridded step)
  is left at its starting state; the first half is fitted.
* ``half_models_left_out``: the barycentre and the weights are taken over
  the first half of the models only.

The cells run on one card, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib

from portbench import work


@contextlib.contextmanager
def _swapped(module, attr, make):
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


def unchanged_fit(config):
    from bayesian_ensembling_tpu_torch.ops import gp

    def make(fit):
        def unchanged(x, y, noise_var, *args, **kwargs):
            params = gp.init_params(x.shape[0], device=y.device, dtype=y.dtype)
            return params, y.new_zeros((x.shape[0], 0))

        return unchanged

    return _swapped(gp, "fit_gp_batch_dispatch", make)


def _half_batch_unfitted(config, which):
    import torch

    from bayesian_ensembling_tpu_torch.ops import gp

    t_faulty = work.collections(config)[which][1]

    def make(fit):
        def half(x, y, noise_var, *args, **kwargs):
            params, losses = fit(x, y, noise_var, *args, **kwargs)
            if y.shape[-1] != t_faulty:
                return params, losses
            b = y.shape[0]
            start = gp.init_params(b, device=y.device, dtype=y.dtype)
            fitted = torch.arange(b, device=y.device) < b // 2
            return gp.BatchedGPParams(
                torch.where(fitted, params.raw_lengthscale.detach(), start.raw_lengthscale),
                torch.where(fitted, params.raw_variance.detach(), start.raw_variance)), losses

        return half

    return _swapped(gp, "fit_gp_batch_dispatch", make)


def half_first_batch_unfitted(config):
    return _half_batch_unfitted(config, 0)


def half_last_batch_unfitted(config):
    return _half_batch_unfitted(config, -1)


def tail_of(config):
    """(module, name) of the entry's tail, where the weights and the
    barycentre are made."""
    if config["entry"] == "multi_scenario":
        from bayesian_ensembling_tpu_torch.parallel import step

        return step, "multi_scenario_tail"
    from bayesian_ensembling_tpu_torch.parallel import gridded

    return gridded, "gridded_tail"


def half_models_left_out(config):
    import torch

    annual = config["entry"] == "multi_scenario"

    def make(tail):
        def half(*args, **kwargs):
            args = list(args)
            if annual:  # model_masks (S, M), the eighth argument
                keep = torch.ones_like(args[7])
                keep[:, keep.shape[1] // 2:] = 0.0
                args[7] = args[7] * keep
            else:  # model_mask (M,) or None, the sixth argument
                m = args[0].shape[0]
                args[5] = (torch.arange(m, device=args[0].device) < m // 2).to(args[0].dtype)
            return tail(*args, **kwargs)

        return half

    return _swapped(*tail_of(config), make)


FAULTS = {"unchanged_fit": unchanged_fit, "half_first_batch_unfitted": half_first_batch_unfitted,
          "half_last_batch_unfitted": half_last_batch_unfitted,
          "half_models_left_out": half_models_left_out}


def planted(name, config):
    """The fault ``name`` planted for a cell of ``config``."""
    return FAULTS[name](config)
