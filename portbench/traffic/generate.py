"""The cells' inputs from a seed.

The CMIP6 and HadCRUT5 fields the system is built for are not in the
repository, so every input is synthetic, with the configuration's shapes.
A configuration names its generator (``"generator"``), a module of
``portbench/generators`` found by that name, and gives it its sizes
(``"shape"``) and the data's parameters (``"data"``); a cell's input pool is
``pool`` independent draws, draw ``i`` from the seed sequence ``(seed, i)``.
Every draw has the same shapes, so the work of a step does not depend on
the seed.
"""

from __future__ import annotations

import importlib

import numpy as np


def pool(config, seed, size):
    """``size`` input sets of ``config``, each rounded once to the
    configuration's dtype (float arrays) so that the program and the
    reference read the same numbers."""
    make = importlib.import_module(f"portbench.generators.{config['generator']}").make
    dtype = np.dtype(config["dtype"])
    sets = []
    for i in range(size):
        rng = np.random.default_rng([seed % 2 ** 64, i])
        sets.append({k: a if a.dtype == bool else a.astype(dtype, copy=False)
                     for k, a in make(config["shape"], config["data"], rng).items()})
    return sets
