"""``monthly``: a copy, with its parameters read from the configuration, of
the native-monthly campaign's generator ``chip_smoke.synthetic_monthly``: a
pool of historical models (each a climate sensitivity, an offset and at
least ``min_realisations`` realisations of monthly AR(1) internal
variability on a forced response), scenarios whose model lists are drawn
from the pool, each warming at its own rate, and observation members
around the forced historical response.  A model's historical block is one
array, read by every scenario that lists it, as the campaign's
deduplication requires; a model has the same realisation count in its
historical and its SSP runs."""

from __future__ import annotations

import numpy as np

from portbench.generators import ar1


def make(shape, data, rng):
    """The unique historical blocks ``hist`` ``(U, R, T_hist)`` and their
    masks ``hist_mask`` ``(U, R)``; the scenarios' model lists ``members``
    ``(S, U)`` (boolean); the SSP blocks ``ssp`` ``(B_ssp, R, T_ssp)``, one
    row a listed (scenario, model) pair in the order of
    ``np.nonzero(members)``; and the observation members ``obs``
    ``(R_obs, T_hist)``.  Padded realisations are zero."""
    u, r, r_min = shape["hist_models"], shape["realisations"], shape["min_realisations"]
    t_hist, t_ssp, r_obs = shape["t_hist"], shape["t_ssp"], shape["obs_members"]
    sizes = shape["ssp_models"]
    if len(sizes) != shape["scenarios"] or max(sizes) != shape["models"] or max(sizes) > u:
        raise ValueError(f"ssp_models {sizes} does not fit scenarios {shape['scenarios']}, "
                         f"models {shape['models']} and hist_models {u}")
    phi, sd = data["ar1_phi"], data["ar1_sd"]
    forced_h = data["forced_scale"] * (np.arange(t_hist) / (t_hist - 1)) ** data["forced_power"] \
        + data["forced_offset"]
    sens = rng.normal(1.0, data["sensitivity_sd"], u)
    offset = rng.normal(0.0, data["offset_sd"], u)
    counts = rng.integers(r_min, r + 1, u)
    counts[0], counts[-1] = r_min, r
    hist = np.zeros((u, r, t_hist))
    for k in range(u):
        hist[k, :counts[k]] = sens[k] * forced_h + offset[k] + ar1(rng, (counts[k], t_hist), phi,
                                                                   sd)
    members = np.zeros((len(sizes), u), bool)
    ssp = []
    lo, hi = data["warming_rate"]
    for si, m_s in enumerate(sizes):
        if si == 0:
            listed = np.arange(m_s)
        elif si == 1:
            listed = np.arange(u - m_s, u)
        else:
            listed = np.sort(rng.choice(u, m_s, replace=False))
        members[si, listed] = True
        # degC a year after the historical period, over the months of a year
        rate = (lo + (hi - lo) * si / max(len(sizes) - 1, 1)) / data["steps_per_year"]
        forced_s = forced_h[-1] + rate * np.arange(1, t_ssp + 1)
        for k in listed:
            row = np.zeros((r, t_ssp))
            row[:counts[k]] = sens[k] * forced_s + offset[k] + ar1(rng, (counts[k], t_ssp), phi,
                                                                   sd)
            ssp.append(row)
    obs = forced_h + ar1(rng, (r_obs, t_hist), phi, data["obs_sd"])
    return {"hist": hist, "hist_mask": np.arange(r)[None, :] < counts[:, None],
            "members": members, "ssp": np.stack(ssp), "obs": obs}
