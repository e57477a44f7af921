"""The cells' inputs from a seed.

The CMIP6 and HadCRUT5 fields the system is built for are not in the
repository, so every input is synthetic, with the configuration's shapes.
A configuration names its generator (``"generator"``) and gives it its
sizes (``"shape"``) and the data's parameters (``"data"``); a cell's input
pool is ``pool`` independent draws, draw ``i`` from the seed sequence
``(seed, i)``.  Every draw has the same shapes, so the work of a step does
not depend on the seed.

``annual``: a copy, with its parameters read from the configuration, of
the flagship generator ``chip_smoke.synthetic_flagship`` (GMST-anomaly-like
blocks: a forced response scaled by each model's sensitivity plus an
offset, AR(1) internal variability a realisation, a warming rate a
scenario, ragged realisation counts zero padded, scenarios with fewer real
models padded by repeating model 0, and observation members around the
forced historical response).

``gridded``: a copy, vectorised over the cells and drawn from the seed, of
``benchmarks/gridded_common.make_workload_cells`` (a sine signal plus white
noise for every model, cell and realisation, and for each cell's
observation members), made in float32, with ragged realisation counts: a
model has the same count in every cell, and every seed deals the same set
of counts (spread evenly from ``min_realisations`` to ``realisations``) to
the models in another order, zero padded.
"""

from __future__ import annotations

import numpy as np


def _ar1(rng, shape, phi, sd):
    eps = rng.normal(0.0, sd * np.sqrt(1.0 - phi * phi), size=shape)
    out = np.empty(shape)
    out[..., 0] = rng.normal(0.0, sd, size=shape[:-1])
    for k in range(1, shape[-1]):
        out[..., k] = phi * out[..., k - 1] + eps[..., k]
    return out


def _pad_models(a, m):
    """Pad the leading (model) axis to ``m`` by repeating model 0."""
    return np.concatenate([a] + [a[:1]] * (m - a.shape[0]), axis=0)


def annual(shape, data, rng):
    """Historical and SSP blocks of ``S`` scenarios x ``M`` models x ``R``
    realisations, their masks, the observation members and the model masks."""
    s, m, r = shape["scenarios"], shape["models"], shape["realisations"]
    t_hist, t_ssp, r_obs = shape["t_hist"], shape["t_ssp"], shape["obs_members"]
    m_min, r_min = shape["min_real_models"], shape["min_realisations"]
    phi, sd = data["ar1_phi"], data["ar1_sd"]
    forced_h = data["forced_scale"] * (np.arange(t_hist) / (t_hist - 1)) ** data["forced_power"] \
        + data["forced_offset"]
    hb = np.zeros((s, m, r, t_hist))
    sb = np.zeros((s, m, r, t_ssp))
    hm = np.zeros((s, m, r), bool)
    mm = np.zeros((s, m))
    for si in range(s):
        m_real = m if si == 0 else int(rng.integers(m_min, m + 1))
        sens = rng.normal(1.0, data["sensitivity_sd"], m_real)[:, None, None]
        offset = rng.normal(0.0, data["offset_sd"], m_real)[:, None, None]
        lo, hi = data["warming_rate"]
        rate = lo + (hi - lo) * si / max(s - 1, 1)  # degC per year after the historical period
        forced_s = forced_h[-1] + rate * np.arange(1, t_ssp + 1)
        h = sens * forced_h + offset + _ar1(rng, (m_real, r, t_hist), phi, sd)
        p = sens * forced_s + offset + _ar1(rng, (m_real, r, t_ssp), phi, sd)
        counts = rng.integers(r_min, r + 1, m_real)
        if si == 0:
            counts[0], counts[-1] = r_min, r
        mask = np.arange(r)[None, :] < counts[:, None]
        h[~mask] = 0.0
        p[~mask] = 0.0
        hb[si], hm[si], sb[si] = _pad_models(h, m), _pad_models(mask, m), _pad_models(p, m)
        mm[si, :m_real] = 1.0
    obs = forced_h + _ar1(rng, (r_obs, t_hist), phi, data["obs_sd"])
    return {"hist_blocks": hb, "hist_masks": hm, "ssp_blocks": sb, "ssp_masks": hm.copy(),
            "obs": obs, "model_masks": mm}


def gridded(shape, data, rng):
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


GENERATORS = {"annual": annual, "gridded": gridded}


def pool(config, seed, size):
    """``size`` input sets of ``config``, each rounded once to the
    configuration's dtype (float arrays) so that the program and the
    reference read the same numbers."""
    make = GENERATORS[config["generator"]]
    dtype = np.dtype(config["dtype"])
    sets = []
    for i in range(size):
        rng = np.random.default_rng([seed % 2 ** 64, i])
        sets.append({k: a if a.dtype == bool else a.astype(dtype, copy=False)
                     for k, a in make(config["shape"], config["data"], rng).items()})
    return sets
