"""The benchmark's files, names, counts and imports; a card smoke of each cell.

    python -m pytest portbench/tests -q            # here, on the CPU
    python -m pytest portbench/tests -q -m gpu     # on the card: the smokes and the control
"""

from __future__ import annotations

import ast
import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from portbench import run, work  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "bayesian_ensembling_tpu"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_has_the_contract_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[key]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in b[key]}) == len(b[key])
    assert all(UNIT.match(m["unit"]) for key in ("end_to_end", "per_layer") for m in b[key])
    assert all(m["better"] in ("lower", "higher") for key in ("end_to_end", "per_layer")
               for m in b[key])


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_every_cell_loads_with_its_files(workload):
    cell = run.Cell.named(workload)
    b = bench()
    config = next(c for c in b["configs"] if c["name"] == cell.config["name"])
    assert (ROOT / config["file"]).is_file()
    assert cell.config["reduced"] == config["reduced"]
    assert (BENCH / "entries" / f"{cell.config['entry']}.py").is_file()
    assert (BENCH / "generators" / f"{cell.config['generator']}.py").is_file()
    entry = importlib.import_module(f"portbench.entries.{cell.config['entry']}")
    for name in ("OUTPUTS", "TINY", "tensors", "step", "reference", "collections"):
        assert hasattr(entry, name), name
    assert set(entry.TINY) <= set(cell.config["shape"])
    for check in cell.workload["checks"].values():
        assert check["output"] in entry.OUTPUTS and check["statistic"] in run.STATISTICS
        assert check["limit"] > 0.0
    assert cell.profile["dba_iterations"] > 0 and cell.workload["pool"] >= 2
    metrics = cell.end_to_end + cell.per_layer
    assert {"setup_s", "step_s"} <= {m["name"] for m in cell.end_to_end}
    assert cell.per_layer
    for m in metrics:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_a_ranked_row_statistic_reads_a_fault_confined_to_that_many_rows():
    import numpy as np

    diff = np.full((7, 10), 1e-6)
    diff[3:] = 1.0  # 4 of 7 rows (scenarios) wrong
    assert run.statistic({"statistic": "median", "row_rank": 4}, diff) == 1.0
    assert run.statistic({"statistic": "median", "row_rank": 5}, diff) == 1e-6
    assert run.statistic({"statistic": "max", "row_rank": 1}, diff) == 1.0
    assert run.statistic({"statistic": "p25"}, diff) == 1e-6  # over all 70 gaps


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    b = bench()
    named = {m["name"] for key in ("end_to_end", "per_layer") for m in b[key]}
    readers = {p.stem for p in (BENCH / "metrics").glob("*.py")}
    assert named == readers
    for name in named:
        src = (BENCH / "metrics" / f"{name}.py").read_text()
        assert "def read(ctx)" in src


def test_a_metric_that_finds_nothing_is_left_out():
    cell = run.Cell.named("gridded-5deg.fast")
    ctx = run.Context(cell=cell, setup_s=1.0, step_s=0.5, peak_window_bytes=0)
    assert run.read_metric("chol_solve_roofline", ctx) is None
    assert run.read_metric("span.fit_ms", ctx) is None
    assert run.read_metric("device.idle_pct", ctx) is None
    assert run.read_metric("step_mfu", ctx) > 0.0


@pytest.mark.parametrize("b, t", [(112, 165), (41472, 86)])
def test_kernel_work_matches_hand_counts(b, t):
    nbytes, ops = work.chol_solve_work(b, t)
    assert nbytes == b * 4 * (t * t + t + t * t + t + t + 1 + t)  # K, y in; L, z, alpha, logdet out
    assert ops == pytest.approx(b * (t ** 3 / 3 + t * t + t * t))
    nbytes, ops = work.tri_inv_work(b, t)
    assert nbytes == b * 4 * (sum(range(1, t + 1)) + t * t)
    assert ops == pytest.approx(b * t ** 3 / 3)
    assert work.dba_update_work(b, t) == (b * 4 * t * 4, b * 5 * t * t)


@pytest.mark.parametrize("b, t, d", [(112, 165, 29), (41472, 86, 29)])
def test_step_operations_match_hand_counts(b, t, d):
    t3, t2 = t ** 3 / 3, t * t
    value = b * (6 * t2 + t3 + t2 + 3 * t)
    grad = value + b * (2 * t3 + 12 * t2)
    assert work.value_ops(b, t) == pytest.approx(value)
    assert work.value_and_grad_ops(b, t) == pytest.approx(grad)
    posterior = b * (6 * t2 + 2 * t3 + 3 * t3 + 6 * t2)
    assert work.posterior_ops(b, t) == pytest.approx(posterior)
    distances = b * (2 * t2 * d + 3 * t2)
    adam = {"optimizer": "adam", "n_optim_nits": 7, "dba_iterations": 2}
    bfgs = {"optimizer": "bfgs", "n_optim_nits": 7, "dba_iterations": 2}
    dba = 2 * 5 * b * d * t2
    assert work.emulation_ops(b, t, d, adam) == pytest.approx(
        dba + b * 4 * t * d + distances + 7 * grad + posterior)
    assert work.emulation_ops(b, t, d, bfgs) == pytest.approx(
        dba + b * 4 * t * d + distances + 7 * (grad + value) + posterior)


def svgp_step_by_hand(p, n, d, g):
    """One SVGP step's operations, the terms of ``work.svgp_step_terms``
    collected by hand by their powers of p, n, d and the group count g."""
    return (8 * p ** 3 / 3 + 6 * p * p * n + 4 * p * n * d + 25 * g * p * n + 18 * p * n
            + 4 * p * p * d + 27 * g * p * p + 9.5 * p * p + 2 * n * d + 24 * p * d + 17 * n
            + 39.5 * p + 3 * g * p + 44 * g)


def svgp_predict_by_hand(p, m, d, g):
    """The SVGP's marginals at m points, collected by hand likewise."""
    return (p ** 3 / 3 + 2 * p * p * m + 7 * p * m + 2 * p * m * d + 13 * g * p * m
            + 2 * p * p * d + 13 * g * p * p + 6 * p * d + 2 * m * d + 4 * m + 6 * p + 10 * g)


def test_the_svgp_counts_match_hand_counts_at_a_tiny_shape():
    """(p, n, N, d) = (3, 2, 4, 5): groups of widths 2, 1, 1, 1, each term
    worked out by hand."""
    widths = work.svgp_widths(5)
    assert widths == (2, 1, 1, 1)
    assert work.svgp_step_ops(1, 3, 2, widths) == 2990 == svgp_step_by_hand(3, 2, 5, 4)
    assert work.svgp_step_ops(7, 3, 2, widths) == 7 * 2990
    assert work.svgp_predict_ops(1, 3, 4, widths) == 1671 == svgp_predict_by_hand(3, 4, 5, 4)
    # 3 pairs of 5 * 16, their 6 row-sum additions and 3 comparisons, then
    # 2 classic updates of 3 pairs of 5 * 16.
    assert work.medoid_dba_ops(1, 3, 4, 2) == 240 + 6 + 3 + 480
    assert work.additive_matern32_ops(3, 2, (2, 1)) == (24 + 20 + 78) + (12 + 10 + 78)


def test_the_svgp_counts_match_hand_counts_at_the_5_degree_grid():
    """(b, P, n, N, D) = (16, 400, 500, 222,912, 33): 16 models of 86 years
    x 2,592 cells, 29 realisations; the DBA over the 16 x 2,592 cells."""
    b, p, n, big_n, d = 16, 400, 500, 86 * 2592, 33
    widths = work.svgp_widths(d)
    assert widths == (2, 1, 1, 29) and big_n == 222912
    step = work.svgp_step_ops(b, p, n, widths)
    assert step == pytest.approx(b * svgp_step_by_hand(p, n, d, 4), rel=1e-15)
    assert step == pytest.approx(11855451882.666666, rel=1e-15)
    terms = work.svgp_step_terms(b, p, n, widths)
    assert sum(terms.values()) == step and all(v > 0 for v in terms.values())
    # The reverse mode of each forward term is written out, not a multiple.
    assert terms["cholesky_grad"] == b * (7 * p ** 3 / 3 + p * p)
    assert terms["solve_grad"] == b * (p * p * n + p * (p + 1) * n)
    predict = work.svgp_predict_ops(b, p, big_n, widths)
    assert predict == pytest.approx(b * svgp_predict_by_hand(p, big_n, d, 4), rel=1e-15)
    assert predict == pytest.approx(1320533421013.3335, rel=1e-15)
    pairs = 16 * 2592 * 29 * 28 // 2
    assert work.medoid_dba_ops(16 * 2592, 29, 86, 10) == (
        pairs * 5 * 86 * 86 + 2 * pairs + 16 * 2592 * 29 + 10 * 5 * 16 * 2592 * 29 * 86 * 86)
    assert work.medoid_dba_ops(16 * 2592, 29, 86, 10) == 1067444531712


def test_the_peaks_are_the_configuration_dtype_s():
    assert work.PEAK_FLOPS == {"float32": 67e12, "float64": 67e12}
    assert work.peak_flops({"dtype": "float64"}) == work.FP64_FLOPS
    assert work.least_seconds(0.0, 67e12, "float64") == 1.0
    assert work.least_seconds(3.35e12, 0.0, "float64") == 1.0
    cell = run.Cell.named("gridded-5deg.fast")
    ctx = run.Context(cell=cell, setup_s=1.0, step_s=0.5, peak_window_bytes=0)
    ops = work.step_ops(cell.config, cell.profile)
    assert run.read_metric("step_mfu", ctx) == 100.0 * ops / (0.5 * work.FP32_FLOPS)


# What the harness counted and drew before the entries counted their own
# batches and each generator had a file of its own: the pools of seed 7 (two
# draws, each array's name, dtype, shape and bytes, SHA-256) and the counts.
PINNED = {
    "annual-flagship.faithful": dict(
        pool="926d54ee2da59a929d1341d00c048cd37d13a8d3082724c406421054656b0504",
        collections=[(112, 165, 29), (112, 86, 29)], step_ops=1303094225141.3333,
        chol_solve=0.018798113165373134, tri_inv=0.013930266727164178),
    "gridded-5deg.fast": dict(
        pool="283f2d1edd0c86b41ca016366ad4986b3cc2513d496a1ff9274868bcc200fb68",
        collections=[(41472, 86, 29)], step_ops=1806552557568.0,
        chol_solve=0.0457235361241791, tri_inv=0.01709621920477612),
}


def pool_digest(config, seed, size):
    import hashlib

    from portbench.traffic import generate

    digest = hashlib.sha256()
    for x in generate.pool(config, seed, size):
        for key in sorted(x):
            a = x[key]
            for part in (key, str(a.dtype), str(a.shape)):
                digest.update(part.encode())
            digest.update(a.tobytes())
    return digest.hexdigest()


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_the_pool_is_the_one_drawn_before(workload):
    cell = run.Cell.named(workload)
    assert pool_digest(cell.config, 7, 2) == PINNED[workload]["pool"]


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_the_operation_counts_are_the_ones_counted_before(workload):
    cell, pinned = run.Cell.named(workload), PINNED[workload]
    assert [tuple(c) for c in work.collections(cell.config)] == pinned["collections"]
    assert work.step_ops(cell.config, cell.profile) == pinned["step_ops"]
    for kernel in ("chol_solve", "tri_inv"):
        assert work.kernel_step_seconds(kernel, cell.config, cell.profile) == pinned[kernel]


def stub_context(cell, traced):
    """A context of ``cell`` as a run fills it, with a stub trace: kernels of
    both rooflines on the card, the port's spans and one optimiser loop,
    which carries the attributes a real loop does (the batch ``B`` and full
    length ``T`` of the cell's first collection, the ``blocked`` route)."""
    import types

    import numpy as np

    from portbench.trace import Trace

    batches = work.collections(cell.config) if hasattr(work.entry_of(cell.config),
                                                       "collections") else []
    loop_attrs = dict(B=batches[0][0], T=batches[0][1], route="blocked") if batches else {}

    ctx = run.Context(cell=cell, setup_s=9.5, step_s=1.5, peak_window_bytes=3 * 2 ** 30)
    if traced:
        host = [("bet.step", 0.0, 2.0), ("bet.fit", 0.1, 1.8), ("bet.fit.loop", 0.2, 1.7),
                ("cudaLaunchKernel", 0.3, 0.31), ("cudaGraphLaunch", 0.5, 0.51)]
        device = [("chol_solve_kernel<float>", 0.3, 0.4), ("tri_inv_kernel<float>", 0.8, 0.3),
                  ("elementwise", 1.2, 0.5)]
        ctx.trace = ctx.program_trace = Trace(
            window_s=2.0, device=device, host_names=[h[0] for h in host],
            host_start=np.array([h[1] for h in host]), host_end=np.array([h[2] for h in host]))
        ctx.program_spans = [
            types.SimpleNamespace(name=name, id=i, root=1, device_ms=ms,
                                  attrs=loop_attrs if name == "fit.loop" else {})
            for i, (name, ms) in enumerate(
                [("step", 1900.0), ("dba", 5.0), ("fit", 1500.0), ("fit.loop", 1400.0),
                 ("posterior", 3.0), ("tail", 2.0)], 1)]
        ctx.fit_steps = {"adam": 2, "bfgs": 0, "lbfgs": 0}
    return ctx


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload, metric", [
    (w["name"], m["name"]) for w in bench()["workloads"]
    for m in run.Cell.named(w["name"]).end_to_end + run.Cell.named(w["name"]).per_layer])
def test_every_reader_of_a_cell_reads_a_number_or_nothing(workload, metric, traced):
    """Each metric that applies to the cell, from a context built from the
    cell's files: a finite number, or None where there is nothing to read;
    never an error.  Traced, every metric of the stub reads a number."""
    import math

    value = run.read_metric(metric, stub_context(run.Cell.named(workload), traced))
    assert value is None or (isinstance(value, float) and math.isfinite(value)), value
    if traced:
        assert value is not None


def test_kernel_least_seconds_at_the_gridded_step():
    cell = run.Cell.named("gridded-5deg.fast")
    b, t = 16 * 36 * 72, 86
    chol = work.kernel_step_seconds("chol_solve", cell.config, cell.profile)
    tri = work.kernel_step_seconds("tri_inv", cell.config, cell.profile)
    assert chol == pytest.approx(61 * b * (2 * t * t + 4 * t + 1) * 4 / 3.35e12)
    assert tri == pytest.approx(31 * b * (t * (t + 1) // 2 + t * t) * 4 / 3.35e12)
    coarse = dict(cell.profile, time_stride=12, fine_steps=20)
    assert work.kernel_step_seconds("chol_solve", cell.config, coarse) is None


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: the port's name begins with the JAX
    package's, so a prefix test would be wrong."""
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"bayesian_ensembling_tpu_torch"}, f"{path}: {name}"
            assert top in {"__future__", "math", "numpy", "torch", "portbench"}, f"{path}: {name}"
            if top == "portbench":
                assert name.startswith("portbench.reference"), f"{path}: {name}"


def test_the_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "bayesian_ensembling_tpu_torchx", sys)
    assert "bayesian_ensembling_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.loaded_forbidden()


def _run(args, cwd, timeout=900):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_a_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run(["--workload", "gridded-5deg.fast", "--seed", "3", "--seconds", "1"], ROOT)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "never falls back to the CPU" in proc.stderr


def test_the_harness_alone_runs_nothing(tmp_path):
    """A directory with BENCHMARK.json and the harness but not the program:
    no result, a non-zero exit."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = _run(["--workload", "gridded-5deg.fast", "--seed", "3", "--seconds", "1"], tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a measured run never falls back to the CPU")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_each_cell_runs_correct_on_the_card(card, workload):
    proc = _run(["--workload", workload, "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert set(result["metrics"]) == {m["name"] for m in run.Cell.named(workload).end_to_end}
