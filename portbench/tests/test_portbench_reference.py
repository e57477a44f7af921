"""The plain reference against the port's CPU path in float64, at tiny shapes
of each cell: the same algorithm, so the answers agree to round-off."""

from __future__ import annotations

import copy
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.reference import dba, gp  # noqa: E402
from portbench.traffic import generate  # noqa: E402

# Float64 round-off carried through a fit: the port and the reference order
# their sums differently, and an optimiser passes the difference on.
F64_TOL = 1e-8


def tiny_cell(name, **profile):
    """The cell cut to its entry's tiny shape (the entry's ``TINY``)."""
    cell = copy.deepcopy(run.Cell.named(name))
    entry = importlib.import_module(f"portbench.entries.{cell.config['entry']}")
    cell.config["shape"].update(entry.TINY)
    cell.traffic[cell.config["entry"]].update(profile)
    return cell


def port_and_reference(cell, seed):
    import bayesian_ensembling_tpu_torch as bt

    entry = importlib.import_module(f"portbench.entries.{cell.config['entry']}")
    x = {k: a.astype(np.float64) if a.dtype != bool else a
         for k, a in generate.pool(cell.config, seed, 1)[0].items()}
    got = run._host(entry.step(bt, entry.tensors(x, torch.float64, torch.device("cpu")),
                               cell.config, cell.profile))
    want = entry.reference(x, cell.config, cell.profile, torch.device("cpu"), torch.float64)
    return got, want


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
@pytest.mark.parametrize("name, profile", [
    ("annual-flagship.faithful", dict(n_optim_nits=60)),
    ("gridded-5deg.fast", dict(n_optim_nits=12)),
    ("annual-flagship.faithful", dict(optimizer="bfgs", n_optim_nits=6, time_stride=3,
                                      fine_steps=4)),
])
def test_reference_matches_the_port_in_float64(name, profile, seed):
    got, want = port_and_reference(tiny_cell(name, **profile), seed)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=F64_TOL)


def test_dba_matches_the_port():
    from bayesian_ensembling_tpu_torch.ops import dtw as port_dtw

    rng = np.random.default_rng(5)
    block = torch.as_tensor(rng.normal(size=(4, 6, 17)))
    mask = torch.as_tensor(np.arange(6)[None, :] < np.array([[2], [6], [4], [3]]))
    block = torch.where(mask[:, :, None], block, 0.0)
    want = port_dtw.dba_batch(block, mask, n_iterations=5, init="mean")
    got = dba.dba(block, mask, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)  # the same paths
    blocked = dba.path_sums(got[:1].expand(6, -1).contiguous(), block[1], table_bytes=1)
    whole = dba.path_sums(got[:1].expand(6, -1).contiguous(), block[1])
    for a, b in zip(blocked, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_the_nlml_gradient_is_the_derivative_of_the_value():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(3, 12, 4)))
    dist = gp.distances(x)
    y = torch.as_tensor(rng.normal(size=(3, 12)))
    noise = torch.as_tensor(rng.uniform(0.05, 0.2, size=(3, 12)))
    raw = torch.as_tensor(rng.normal(0.3, 0.4, size=(3, 2)))
    _, grad = gp.nlml_and_grad(raw, dist, y, noise, 1e-6)
    for i in range(2):
        h = torch.zeros_like(raw)
        h[:, i] = 1e-6
        fd = (gp.nlml(raw + h, dist, y, noise, 1e-6) - gp.nlml(raw - h, dist, y, noise, 1e-6)) / 2e-6
        np.testing.assert_allclose(grad[:, i].numpy(), fd.numpy(), rtol=1e-6, atol=1e-8)
