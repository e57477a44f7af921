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

The tests also plant ``answer_altered``: one output of the tail moved by a
given amount, at its first point or at every point.

The entry names where they are planted (``portbench/entries``): ``FIT_SITE``
and ``TAIL_SITE``, each ``(module, name)``, the name through which the
entry's step reaches its fit and its tail, so that a step that binds a
function by name is broken where it looks the function up.  The fit is the
exact GP's (``BatchedGPParams``, put back at ``gp.init_params``) unless the
entry brings its own ``left_at_start``; the tail drops models by its
signature (``HALF_MODELS``) unless the entry brings its own ``half_models``.

The cells run on one card, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib
import importlib

from portbench import work


@contextlib.contextmanager
def _swapped(module, attr, make):
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


def site(config, kind):
    """``(module, name)`` of the entry's ``FIT_SITE`` (``kind`` "fit") or
    ``TAIL_SITE`` ("tail")."""
    module, attr = getattr(work.entry_of(config), f"{kind.upper()}_SITE")
    return importlib.import_module(module), attr


def gp_left_at_start(config, args, kwargs, result, which):
    """The exact GP's fit (``ops/gp.fit_gp_batch_dispatch``: ``(x, y,
    noise_var, ...)`` -> ``(BatchedGPParams, losses)``) left at its start:
    ``which`` "all", with ``result`` None, is the start of every model and
    no losses; "first" or "last" puts the second half of that batch of
    ``work.collections`` (told by its length T) back at its start, and
    leaves every other batch's ``result`` as it is."""
    import torch

    from bayesian_ensembling_tpu_torch.ops import gp

    x, y = args[0], args[1]
    b = x.shape[0]
    start = gp.init_params(b, device=y.device, dtype=y.dtype)
    if which == "all":
        return start, y.new_zeros((b, 0))
    params, losses = result
    t_faulty = work.collections(config)[{"first": 0, "last": -1}[which]][1]
    if y.shape[-1] != t_faulty:
        return result
    fitted = torch.arange(b, device=y.device) < b // 2
    return gp.BatchedGPParams(
        torch.where(fitted, params.raw_lengthscale.detach(), start.raw_lengthscale),
        torch.where(fitted, params.raw_variance.detach(), start.raw_variance)), losses


def _left_at_start(config):
    return getattr(work.entry_of(config), "left_at_start", gp_left_at_start)


def unchanged_fit(config):
    start = _left_at_start(config)

    def make(fit):
        def unchanged(*args, **kwargs):
            return start(config, args, kwargs, None, "all")

        return unchanged

    return _swapped(*site(config, "fit"), make)


def _half_batch_unfitted(config, which):
    start = _left_at_start(config)

    def make(fit):
        def half(*args, **kwargs):
            return start(config, args, kwargs, fit(*args, **kwargs), which)

        return half

    return _swapped(*site(config, "fit"), make)


def half_first_batch_unfitted(config):
    return _half_batch_unfitted(config, "first")


def half_last_batch_unfitted(config):
    return _half_batch_unfitted(config, "last")


def _halve_model_masks(args, kwargs):
    """``multi_scenario_tail``: ``model_masks`` (S, M), the eighth argument,
    keeps the first half of the models."""
    import torch

    args = list(args)
    keep = torch.ones_like(args[7])
    keep[:, keep.shape[1] // 2:] = 0.0
    args[7] = args[7] * keep
    return args, kwargs


def _halve_model_mask(args, kwargs):
    """``gridded_tail``: ``model_mask`` (M,) or None, the sixth argument,
    becomes the first half of the models."""
    import torch

    args = list(args)
    m = args[0].shape[0]
    args[5] = (torch.arange(m, device=args[0].device) < m // 2).to(args[0].dtype)
    return args, kwargs


# How each tail of the port is told to drop the second half of its models.
HALF_MODELS = {"multi_scenario_tail": _halve_model_masks, "gridded_tail": _halve_model_mask}


def half_models_left_out(config):
    module, attr = site(config, "tail")
    halve = getattr(work.entry_of(config), "half_models", None) or HALF_MODELS[attr]

    def make(tail):
        def half(*args, **kwargs):
            args, kwargs = halve(args, kwargs)
            return tail(*args, **kwargs)

        return half

    return _swapped(module, attr, make)


def answer_altered(config, output, by, everywhere=False):
    """The tail's answer ``output`` (a name of the entry's ``OUTPUTS``)
    moved by ``by``: at its first point, or at every point."""
    j = work.entry_of(config).OUTPUTS.index(output)

    def make(tail):
        def altered(*args, **kwargs):
            out = list(tail(*args, **kwargs))
            out[j] = out[j].clone()
            if everywhere:
                out[j] += by
            else:
                out[j].view(-1)[0] += by
            return tuple(out)

        return altered

    return _swapped(*site(config, "tail"), make)


FAULTS = {"unchanged_fit": unchanged_fit, "half_first_batch_unfitted": half_first_batch_unfitted,
          "half_last_batch_unfitted": half_last_batch_unfitted,
          "half_models_left_out": half_models_left_out}


def planted(name, config):
    """The fault ``name`` planted for a cell of ``config``."""
    return FAULTS[name](config)
