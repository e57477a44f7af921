"""Adapters from the benchmark to the port's entry points.

A configuration names its entry (``"entry"``); the module of that name here
turns the cell's inputs into the entry's tensors, calls the entry for one
step, calls the same work stage by stage under the benchmark's spans, and
calls the plain reference for the same step's answers.  Each module
exposes ``OUTPUTS``, ``tensors``, ``step``, ``staged`` and ``reference``.
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
