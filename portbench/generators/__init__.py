"""The input generators, one module a generator.

A configuration names its generator (``"generator"``); the module of that
name here exposes ``make(shape, data, rng)``, which draws one input set of
the configuration's sizes (``"shape"``) and data parameters (``"data"``)
from the numpy ``Generator`` ``rng`` and returns it as a dict of numpy
arrays.  ``traffic/generate.py`` finds the module by name and rounds what it
draws to the configuration's dtype.  The helpers below are shared.
"""

from __future__ import annotations

import numpy as np


def ar1(rng, shape, phi, sd):
    """AR(1) series along the last axis, stationary with standard deviation
    ``sd`` and lag-one correlation ``phi``."""
    eps = rng.normal(0.0, sd * np.sqrt(1.0 - phi * phi), size=shape)
    out = np.empty(shape)
    out[..., 0] = rng.normal(0.0, sd, size=shape[:-1])
    for k in range(1, shape[-1]):
        out[..., k] = phi * out[..., k - 1] + eps[..., k]
    return out


def pad_models(a, m):
    """Pad the leading (model) axis to ``m`` by repeating model 0."""
    return np.concatenate([a] + [a[:1]] * (m - a.shape[0]), axis=0)
