"""``annual``: a copy, with its parameters read from the configuration, of
the flagship generator ``chip_smoke.synthetic_flagship``: GMST-anomaly-like
blocks (a forced response scaled by each model's sensitivity plus an
offset, AR(1) internal variability a realisation, a warming rate a
scenario), ragged realisation counts zero padded, scenarios with fewer real
models padded by repeating model 0, and observation members around the
forced historical response."""

from __future__ import annotations

import numpy as np

from portbench.generators import ar1, pad_models


def make(shape, data, rng):
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
        h = sens * forced_h + offset + ar1(rng, (m_real, r, t_hist), phi, sd)
        p = sens * forced_s + offset + ar1(rng, (m_real, r, t_ssp), phi, sd)
        counts = rng.integers(r_min, r + 1, m_real)
        if si == 0:
            counts[0], counts[-1] = r_min, r
        mask = np.arange(r)[None, :] < counts[:, None]
        h[~mask] = 0.0
        p[~mask] = 0.0
        hb[si], hm[si], sb[si] = pad_models(h, m), pad_models(mask, m), pad_models(p, m)
        mm[si, :m_real] = 1.0
    obs = forced_h + ar1(rng, (r_obs, t_hist), phi, data["obs_sd"])
    return {"hist_blocks": hb, "hist_masks": hm, "ssp_blocks": sb, "ssp_masks": hm.copy(),
            "obs": obs, "model_masks": mm}
