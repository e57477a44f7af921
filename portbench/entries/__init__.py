"""Adapters from the benchmark to the port's entry points.

A configuration names its entry (``"entry"``); the module of that name here
turns the cell's inputs into the entry's tensors, calls the entry for one
step, calls the plain reference for the same step's answers, and counts the
batches a step emulates.  Each module exposes:

* ``OUTPUTS``: the names of the step's answers, in the entry's order;
* ``tensors(inputs, dtype, device)``: the entry's positional tensors;
* ``step(bt, t, config, profile)``: one step of the port's entry;
* ``reference(inputs, config, profile, device, dtype)``: the plain
  reference's answers of the same step, from a module under
  ``portbench/reference``;
* ``collections(config)``: the batches one step emulates, as ``(b, t, d)``
  triples (models, time steps, realisations), from which
  ``portbench/work.py`` counts the step's operations;
* ``TINY``: shape keys that cut the configuration to a size the CPU tests
  run (``portbench/tests``);
* ``FIT_SITE``, ``TAIL_SITE``: ``(module, name)`` of the fit and of the
  tail as the entry's step reaches them, where ``portbench/faults.py``
  plants its faults (a step that binds a function by name is reached
  through its own module).

An entry of another emulator than the exact GP may also define:

* ``step_ops(config, profile)``: the operations one step needs, which
  ``portbench/work.step_ops`` then takes in place of the exact GP's count
  over ``collections`` (and ``work.kernel_step_seconds`` gives None: the
  exact GP's kernels' rooflines are not its);
* ``left_at_start(config, args, kwargs, result, which)``: its fit's answer
  left at its start, for a state that is not ``BatchedGPParams``
  (``faults.gp_left_at_start`` says what it returns);
* ``half_models(args, kwargs)``: its tail's arguments with the second half
  of the models dropped, for a tail not in ``faults.HALF_MODELS``.

The configuration's ``dtype`` sets the card's peak that the readers divide
by (``work.PEAK_FLOPS``) and the control's precision (``control.py``).
"""

from __future__ import annotations

import numpy as np
import torch

# The exact GP's fit, as every entry's step reaches it.
GP_FIT_SITE = ("bayesian_ensembling_tpu_torch.ops.gp", "fit_gp_batch_dispatch")

# The fit profile's keys that the port's fit takes as they are.
_FIT_KEYS = ("n_optim_nits", "learning_rate", "optimizer", "time_stride", "fine_steps")


def fit_kwargs(profile):
    return {k: profile[k] for k in _FIT_KEYS if k in profile}


def as_tensors(inputs, names, dtype, device):
    """``inputs[name]`` for each of ``names`` on ``device``, in ``dtype``
    (booleans kept)."""
    return tuple(torch.as_tensor(np.asarray(inputs[k]), device=device,
                                 dtype=torch.bool if inputs[k].dtype == bool else dtype)
                 for k in names)
