"""The control fails a cell's comparison; the program passes it (on the card).

For each cell, at its own size and on one seed: the plain reference put in
the program's place one precision below the configuration's (float32 with
TF32 on, where the configuration states float32 with TF32 off) reads over
the limit of at least one of the cell's numbers, and one step of the port
reads within every limit.  ``portbench/control.py`` takes the same readings
over many seeds; ``PERF.md`` gives them.

    python -m pytest portbench/tests/test_portbench_control.py -q -m gpu
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench import control, run  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control's TF32 exists only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_and_the_program_passes(card, workload):
    cell = run.Cell.named(workload)
    got = control.readings(cell, 2147483677, card, program=True)
    limits = {name: check["limit"] for name, check in cell.workload["checks"].items()}
    assert any(got["control"][name] > limit for name, limit in limits.items()), got["control"]
    assert all(got["program"][name] <= limit for name, limit in limits.items()), got["program"]
