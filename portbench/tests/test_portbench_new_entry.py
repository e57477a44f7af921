"""A cell on a new entry of the port is new files alone.

A throwaway entry, its generator, configuration, traffic and cell are
written into a copy of ``portbench/`` beside a copy of ``BENCHMARK.json``
with the new configuration and cell added; no file of the copy is edited.
In a fresh process from the copy's root, ``Cell.named`` loads the cell,
``generate.pool`` draws it, ``work.step_ops`` counts it, every metric that
applies to it reads a number or nothing, and a traced run on the CPU at its
own tiny size comes out correct.
"""

from __future__ import annotations

import filecmp
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

NEW_FILES = {
    # The entry: the mean of each model's realisations, and the mean over
    # the models; its reference works the same out in numpy.
    "entries/toy_mean.py": '''
        """A throwaway entry: each model's mean over its realisations."""

        import numpy as np
        import torch

        from portbench.entries import as_tensors

        OUTPUTS = ("model_mean", "ensemble_mean")
        TINY = dict(models=3, realisations=4, t=5)


        def tensors(inputs, dtype, device):
            return as_tensors(inputs, ("block", "mask"), dtype, device)


        def step(bt, t, config, profile):
            block, mask = t
            w = mask.to(block.dtype)
            mean = (block * w[..., None]).sum(1) / w.sum(1)[:, None]
            return mean, mean.mean(0)


        def reference(inputs, config, profile, device, dtype):
            w = inputs["mask"].astype(np.float64)
            mean = (inputs["block"] * w[..., None]).sum(1) / w.sum(1)[:, None]
            return mean, mean.mean(0)


        def collections(config):
            s = config["shape"]
            return [(s["models"], s["t"], s["realisations"])]
    ''',
    "generators/toy_noise.py": '''
        """A throwaway generator: white noise, every model with at least one
        realisation."""

        import numpy as np


        def make(shape, data, rng):
            m, r, t = shape["models"], shape["realisations"], shape["t"]
            block = rng.normal(0.0, data["sd"], size=(m, r, t))
            mask = np.arange(r)[None, :] < rng.integers(1, r + 1, m)[:, None]
            return {"block": block * mask[..., None], "mask": mask}
    ''',
    "configs/toy.json": {
        "name": "toy", "source": "a throwaway configuration", "entry": "toy_mean",
        "generator": "toy_noise", "dtype": "float32", "reduced": [],
        "shape": {"models": 3, "realisations": 4, "t": 5}, "data": {"sd": 0.5}},
    "traffic/plain.json": {
        "name": "plain", "toy_mean": {"optimizer": "adam", "n_optim_nits": 3,
                                      "dba_iterations": 1},
        "warmup": {"n_optim_nits": 1}},
    "workloads/toy.plain.json": {
        "name": "toy.plain", "config": "toy", "traffic": "plain", "pool": 2,
        "why": "a throwaway cell",
        "checks": {"model_mean_max": {"output": "model_mean", "statistic": "max",
                                      "limit": 1e-5}}},
}

PROBE = '''
import json, math, sys
sys.path.insert(0, ".")
sys.path.append(sys.argv[1])  # the port, from the repository
import torch
from portbench import run, work
from portbench.traffic import generate
from portbench.tests.test_portbench_harness import stub_context

cell = run.Cell.named("toy.plain")
pool = generate.pool(cell.config, 2 ** 31 + 3, 2)
out = {"shapes": {k: list(a.shape) for k, a in pool[0].items()},
       "step_ops": work.step_ops(cell.config, cell.profile), "metrics": {}}
for traced in (False, True):
    for m in cell.end_to_end + cell.per_layer:
        value = run.read_metric(m["name"], stub_context(cell, traced))
        assert value is None or math.isfinite(value), (m["name"], value)
        out["metrics"][f"{m['name']}:{traced}"] = value
result, _ = run.run_cell(cell, 2 ** 31 + 3, 0.2, True, torch.device("cpu"))
out["correct"], out["attempted"] = result["correct"], result["attempted"]
print(json.dumps(out))
'''


def test_a_cell_on_a_new_entry_needs_only_new_files(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    for name, body in NEW_FILES.items():
        path = copy / name
        assert not path.exists(), f"{name} is not a new file"
        path.write_text(json.dumps(body, indent=1) if isinstance(body, dict)
                        else textwrap.dedent(body).lstrip())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a throwaway configuration",
                             "file": "portbench/configs/toy.json", "reduced": [],
                             "why": "a throwaway configuration"})
    bench["workloads"].append({"name": "toy.plain", "config": "toy", "traffic": "plain",
                               "chips": 1, "why": "a throwaway cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    # Every file the copy shares with the harness is unchanged.
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert filecmp.cmp(path, copy / path.relative_to(BENCH), shallow=False), path

    proc = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["shapes"] == {"block": [3, 4, 5], "mask": [3, 4]}
    assert out["step_ops"] > 0.0
    assert out["metrics"]["step_s:False"] == 1.5 and out["metrics"]["step_mfu:True"] > 0.0
    assert out["metrics"]["span.fit_ms:True"] == 1500.0
    assert "fits_per_s:True" not in out["metrics"]  # a metric of the gridded cell alone
    assert out["correct"] and out["attempted"] >= 1
