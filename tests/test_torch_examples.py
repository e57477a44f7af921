"""The port's examples (``bayesian_ensembling_tpu_torch/examples``) on the
CPU against the JAX package's ``examples/``.

Each JAX example runs as ``tests/test_examples.py`` runs it and its printed
output is read back; the port's example runs with ``--device cpu`` in the
same float32 working precision.  Every number printed by both must agree
within 2e-3: the lines print three decimals (two for the grid), and the two
packages' float32 fits round differently.  The one line that prints a
round-off measure (the refinement's drift) is held below its 1e-3 bound on
both sides instead.  ``main`` returns what it printed, to the printed
precision.
"""

import os
import re
import runpy
import sys

import numpy as np
import pytest

from bayesian_ensembling_tpu_torch.examples import gridded_quickstart as t_gridded
from bayesian_ensembling_tpu_torch.examples import gridded_refined as t_refined
from bayesian_ensembling_tpu_torch.examples import monthly_warm as t_monthly
from bayesian_ensembling_tpu_torch.examples import quickstart as t_quickstart

PRINT_TOL = 2e-3
EXAMPLES = {
    "quickstart": (t_quickstart, ("ensemble mean at final year", "NLL vs obs")),
    "monthly_warm": (t_monthly, ("monthly ensemble mean at final month", "NLL vs obs")),
    "gridded_quickstart": (t_gridded, ("mean weight per model",)),
    "gridded_refined": (t_refined, ("refined moments dtype: float64", "drift removed")),
}
_NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?")


def _jax_output(name, capsys):
    path = os.path.join(os.path.dirname(__file__), "..", "examples", f"{name}.py")
    argv = sys.argv
    sys.argv = [name]
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv
    return capsys.readouterr().out


def _numbers(text):
    return [float(x) for line in text.splitlines() if "drift" not in line
            for x in _NUMBER.findall(line.split(":", 1)[-1])]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_port_example_prints_what_the_jax_example_prints(name, capsys):
    module, phrases = EXAMPLES[name]
    want = _jax_output(name, capsys)
    got_numbers = module.main(["--device", "cpu"])
    got = capsys.readouterr().out
    for phrase in phrases:
        assert phrase in got and phrase in want
    assert [line.split(":")[0] for line in got.splitlines()] == \
        [line.split(":")[0] for line in want.splitlines()]
    g, w = _numbers(got), _numbers(want)
    assert len(g) == len(w) > 0
    np.testing.assert_allclose(g, w, rtol=0, atol=PRINT_TOL)
    if name == "gridded_refined":
        drifts = [float(_NUMBER.findall(t.split("removed:")[1])[0])
                  for t in (got, want)]
        assert all(0 <= d < 1e-3 for d in drifts)
        assert got_numbers["drift"] == drifts[0] or abs(got_numbers["drift"] - drifts[0]) < 1e-9


def test_returned_numbers_are_the_printed_ones(capsys):
    out = t_quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert f"ensemble mean at final year: {out['mean']:.3f}" in text
    assert f"NLL vs obs: {out['nll']:.3f}" in text
    for w in out["weights"]:
        assert f": {w:.3f}" in text
    refined = t_refined.main(["--device", "cpu"])
    assert refined["refined_mean"].dtype == np.float64 and refined["fit_mean"].shape == (8, 24)
    grid = t_gridded.main(["--device", "cpu"])
    assert grid["mean_final"].shape == (4, 6) and grid["weight_per_model"].shape == (3,)


@pytest.mark.parametrize("name", ["quickstart", "gridded_refined"])
def test_float64_run_agrees_with_float32(name, capsys):
    """``--dtype float64``: what ``chip_smoke.py`` phase 14 holds the card's
    float32 run to, here both on the CPU (0.01 degC)."""
    module = EXAMPLES[name][0]
    f32 = module.main(["--device", "cpu"])
    f64 = module.main(["--device", "cpu", "--dtype", "float64"])
    capsys.readouterr()
    key = "mean" if name == "quickstart" else "fit_mean"
    assert np.max(np.abs(np.asarray(f32[key]) - np.asarray(f64[key]))) < 0.01


def test_cuda_default_raises_without_cuda():
    """The examples run on the card unless asked for the CPU; with no card
    the default raises rather than falling back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_quickstart.main([])
