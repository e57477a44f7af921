"""``gridded``: a copy, vectorised over the cells and drawn from the seed, of
``benchmarks/gridded_common.make_workload_cells``: a sine signal plus white
noise for every model, cell and realisation, and for each cell's
observation members, made in float32, with ragged realisation counts: a
model has the same count in every cell, and every seed deals the same set
of counts (spread evenly from ``min_realisations`` to ``realisations``) to
the models in another order, zero padded."""

from __future__ import annotations

import numpy as np


def make(shape, data, rng):
    """Blocks ``(M, C, R, T)`` of ``C = lat x lon`` cells, their masks
    ``(M, C, R)`` and each cell's observation members ``(C, R_obs, T)``."""
    m, r, t, r_obs = shape["models"], shape["realisations"], shape["t"], shape["obs_members"]
    c = shape["lat"] * shape["lon"]
    signal = np.sin(np.linspace(0.0, data["signal_span"], t)).astype(np.float32)
    noise = np.float32(data["noise_sd"])
    counts = rng.permutation(np.rint(np.linspace(shape["min_realisations"], r, m)).astype(int))
    mask = np.broadcast_to(np.arange(r)[None, None, :] < counts[:, None, None], (m, c, r)).copy()
    block = rng.standard_normal((m, c, r, t), dtype=np.float32)
    block *= noise
    block += signal
    block *= mask[..., None]
    obs = rng.standard_normal((c, r_obs, t), dtype=np.float32)
    obs *= noise
    obs += signal
    return {"block": block, "mask": mask, "obs": obs}
