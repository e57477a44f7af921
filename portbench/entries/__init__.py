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
  run (``portbench/tests``).
"""

from __future__ import annotations

import numpy as np
import torch

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
