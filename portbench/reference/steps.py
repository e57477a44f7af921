"""Whole steps of the reference, one for each entry of the port a cell drives.

Each takes the cell's inputs as numpy arrays, the configuration and the fit
profile, and returns the step's answers as float64 numpy arrays in the
order of the port's entry: ``(bary_mean, bary_std, weights)``.  ``dtype``
and the TF32 switches set the precision it computes in: float64 for the
comparison, float32 with TF32 on for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import dba, gp, tail


def _tensor(a, dtype, device):
    a = np.asarray(a)
    return torch.as_tensor(a, device=device, dtype=torch.bool if a.dtype == bool else dtype)


def _emulate(block, mask, config, profile):
    """Marginal means and variances ``(*lead, T)`` of blocks ``(*lead, R, T)``."""
    *lead, r, t = block.shape
    mean, var = gp.emulate(block.reshape(-1, r, t), mask.reshape(-1, r), profile,
                           config["kernel"], config["jitter"], dba.dba)
    return mean.reshape(*lead, t), var.reshape(*lead, t)


def _supported(config):
    """The reference computes CRPS weights and the W2 barycentre's std (the
    weighted mean of the standard deviations) only; it refuses a
    configuration that names another weighting or another std."""
    for key, have in (("weight_kind", "crps"), ("sigma_mode", "w2")):
        if config[key] != have:
            raise ValueError(f"the reference has {key} {have!r} only, not {config[key]!r}")


def _numpy(*arrays):
    return tuple(a.double().cpu().numpy() for a in arrays)


@torch.no_grad()
def multi_scenario(inputs, config, profile, device, dtype=torch.float64):
    """``S`` scenarios of ``M`` models: each model's historical and SSP
    collections emulated, its weight from the historical marginals against
    the observations, the W2 barycentre of the SSP marginals.  Returns
    ``(bary_mean (S, T_ssp), bary_std (S, T_ssp), weights (S, M))``."""
    _supported(config)
    hb, hm, sb, sm, obs, mm = (_tensor(inputs[k], dtype, device) for k in
                               ("hist_blocks", "hist_masks", "ssp_blocks", "ssp_masks", "obs",
                                "model_masks"))
    h_mean, h_var = (a.transpose(0, 1) for a in _emulate(hb, hm, config, profile))  # (M, S, T)
    s_mean, s_var = (a.transpose(0, 1) for a in _emulate(sb, sm, config, profile))
    w = tail.weights(h_mean, h_var, obs, mm.T)
    mean, std = tail.barycentre(w, s_mean, s_var)
    return _numpy(mean, std, w.T)


@torch.no_grad()
def gridded(inputs, config, profile, device, dtype=torch.float64):
    """``M`` models on ``C`` cells, each (model, cell) emulated alone; per
    cell the weights from the marginals against that cell's observations
    and the W2 barycentre of the same marginals.  Returns ``(bary_mean
    (C, T), bary_std (C, T), weights (M, C))``."""
    _supported(config)
    block, mask, obs = (_tensor(inputs[k], dtype, device) for k in ("block", "mask", "obs"))
    mean, var = _emulate(block, mask, config, profile)  # (M, C, T)
    w = tail.weights(mean, var, obs, torch.ones(mean.shape[:2], dtype=dtype, device=device))
    bary_mean, bary_std = tail.barycentre(w, mean, var)
    return _numpy(bary_mean, bary_std, w)
