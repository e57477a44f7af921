"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``run.run_cell``: inputs, warm-up,
window, reference, comparison) at a tiny shape on the CPU, skipping only
the harness's look for a card, with one fault planted in the port where the
answer is made (``portbench/faults.py``):

* the fit returns its starting state unchanged;
* the second half of the step's first fit batch is left at its start (in
  the annual cell, the historical fits of half of the scenarios: their
  weights are wrong);
* half of the models are left out and the barycentre is taken over the rest;
* one answer is altered where it is produced, by twice the limit of the
  number that compares it (at one point for a widest gap, at every point
  for a median gap).

Each fault is planted at the sites the cell's entry names (``FIT_SITE``,
``TAIL_SITE``): in the monthly cell the tail as the campaign binds it.
The cells run on one card, so no exchange between chips can be left out.
Sound runs at the same size come out correct.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench import faults, run  # noqa: E402

CELLS = {
    "annual-flagship.faithful": (dict(scenarios=7, models=4, min_real_models=3, realisations=5,
                                      t_hist=14, t_ssp=9, obs_members=6), dict(n_optim_nits=60)),
    "gridded-5deg.fast": (dict(models=4, lat=2, lon=2, realisations=4, t=11, obs_members=5),
                          dict(n_optim_nits=12)),
    # Seven scenarios, so that a check ranked over scenarios has its rows;
    # two historical chunks (5 models in chunks of 3).
    "monthly-campaign.fast-monthly": (
        dict(scenarios=7, hist_models=5, ssp_models=[4, 3, 3, 2, 2, 2, 2], models=4,
             realisations=4, min_realisations=3, t_hist=26, t_ssp=14, obs_members=6,
             hist_chunk=3),
        dict(n_optim_nits=60, time_stride=3, fine_steps=20, dba_iterations=3)),
}
SEED = 2 ** 31 + 101


def tiny_cell(name):
    """The cell at a tiny shape, with a pool of one input set, so that the
    answers compared do not hang on how many steps the window finishes."""
    shape, profile = CELLS[name]
    cell = copy.deepcopy(run.Cell.named(name))
    cell.config["shape"].update(shape)
    cell.traffic[cell.config["entry"]].update(profile)
    cell.workload["pool"] = 1
    return cell


def run_tiny(cell):
    result, checks = run.run_cell(cell, SEED, 0.5, False, torch.device("cpu"))
    assert list(result)[-1] == "checks" and result["attempted"] >= 1
    return result


def run_with_fault(name, fault):
    cell = tiny_cell(name)
    with faults.planted(fault, cell.config):
        return run_tiny(cell)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_sound_run_is_correct(name):
    result = run_tiny(tiny_cell(name))
    assert result["correct"] and result["failed"] == 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_fit_that_returns_its_state_unchanged_is_not_correct(name):
    assert not run_with_fault(name, "unchanged_fit")["correct"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_half_of_a_fit_batch_left_at_its_start_is_not_correct(name):
    assert not run_with_fault(name, "half_first_batch_unfitted")["correct"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_half_of_the_models_left_out_is_not_correct(name):
    assert not run_with_fault(name, "half_models_left_out")["correct"]


def _checks():
    return [(name, check) for name in sorted(CELLS)
            for check in run.Cell.named(name).workload["checks"].items()]


@pytest.mark.parametrize("name, check", _checks(), ids=lambda v: v if isinstance(v, str) else v[0])
def test_one_answer_altered_where_it_is_produced_is_not_correct(name, check):
    """The output a number compares, altered by twice its limit where the
    tail produces it: at one point for a widest gap, everywhere for a median."""
    number, spec = check
    cell = tiny_cell(name)
    with faults.answer_altered(cell.config, spec["output"], 2.0 * spec["limit"],
                               everywhere=spec["statistic"] != "max"):
        result = run_tiny(cell)
    assert not result["correct"]
    assert result["checks"][number]["value"] > spec["limit"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_each_fault_is_planted_where_the_entry_names_it(name):
    """The fault replaces the function the entry's step looks up, and puts it
    back after."""
    config = tiny_cell(name).config
    for kind, fault in (("fit", "unchanged_fit"), ("tail", "half_models_left_out")):
        module, attr = faults.site(config, kind)
        original = getattr(module, attr)
        with faults.planted(fault, config):
            assert getattr(module, attr) is not original
        assert getattr(module, attr) is original
