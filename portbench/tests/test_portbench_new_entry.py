"""A cell on a new entry of the port is new files alone.

A throwaway entry, its generator, configuration, traffic and cell are
written into a copy of ``portbench/`` beside a copy of ``BENCHMARK.json``
with the new configuration and cell added; no file of the copy is edited.
In a fresh process from the copy's root, ``Cell.named`` loads the cell,
``generate.pool`` draws it, ``work.step_ops`` counts it, every metric that
applies to it reads a number or nothing, and a traced run on the CPU at its
own tiny size comes out correct.

A second throwaway entry stands for another emulator in float64: it counts
its own operations (``step_ops``), names its own fit and tail as the sites
of the faults and brings its own state left at its start and its own way of
dropping models.  ``step_mfu`` divides its count by the float64 peak, the
control computes the reference in float32 and misses, and each fault,
planted at the entry's sites, makes a run come out not correct.
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


def copy_with(tmp_path, new_files, config, cell):
    """A copy of the harness with ``new_files`` added and a BENCHMARK.json
    with ``config`` and ``cell`` added; every file it shares with the
    harness unchanged."""
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    for name, body in new_files.items():
        path = copy / name
        assert not path.exists(), f"{name} is not a new file"
        path.write_text(json.dumps(body, indent=1) if isinstance(body, dict)
                        else textwrap.dedent(body).lstrip())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(config)
    bench["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert filecmp.cmp(path, copy / path.relative_to(BENCH), shallow=False), path


def probe(tmp_path, code):
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_cell_on_a_new_entry_needs_only_new_files(tmp_path):
    copy_with(tmp_path, NEW_FILES,
              {"name": "toy", "source": "a throwaway configuration",
               "file": "portbench/configs/toy.json", "reduced": [],
               "why": "a throwaway configuration"},
              {"name": "toy.plain", "config": "toy", "traffic": "plain", "chips": 1,
               "why": "a throwaway cell"})
    out = probe(tmp_path, PROBE)
    assert out["shapes"] == {"block": [3, 4, 5], "mask": [3, 4]}
    assert out["step_ops"] > 0.0
    assert out["metrics"]["step_s:False"] == 1.5 and out["metrics"]["step_mfu:True"] > 0.0
    assert out["metrics"]["span.fit_ms:True"] == 1500.0
    assert "fits_per_s:True" not in out["metrics"]  # a metric of the gridded cell alone
    assert out["correct"] and out["attempted"] >= 1


F64_FILES = {
    # Another emulator: each model's mean over its realisations, reached by a
    # fit that halves its gap from zero ``n_optim_nits`` times on each half of
    # the series (two fit batches), then a tail that averages the models a
    # mask keeps.  Its state is a plain tensor, not BatchedGPParams.
    "entries/toy_halving.py": '''
        """A throwaway entry of another emulator, in float64."""

        import torch

        from portbench.entries import as_tensors

        OUTPUTS = ("model_mean", "ensemble_mean")
        TINY = dict(models=4, realisations=4, t=6)
        FIT_SITE = ("portbench.entries.toy_halving", "fit")
        TAIL_SITE = ("portbench.entries.toy_halving", "tail")
        SEEN = []  # (dtype of the inputs, dtype computed in) of each reference call


        def fit(block, mask, steps, batch):
            w = mask.to(block.dtype)
            target = (block * w[..., None]).sum(1) / w.sum(1)[:, None]
            state = torch.zeros_like(target)
            for _ in range(steps):
                state = state + 0.5 * (target - state)
            return state


        def tail(means, model_mask):
            return means, (means * model_mask[:, None]).sum(0) / model_mask.sum()


        def tensors(inputs, dtype, device):
            return as_tensors(inputs, ("block", "mask"), dtype, device)


        def step(bt, t, config, profile):
            block, mask = t
            half, n = block.shape[-1] // 2, profile["n_optim_nits"]
            means = torch.cat([fit(block[..., :half], mask, n, batch=0),
                               fit(block[..., half:], mask, n, batch=1)], dim=-1)
            return tail(means, torch.ones(means.shape[0], dtype=means.dtype))


        def reference(inputs, config, profile, device, dtype):
            SEEN.append((str(inputs["block"].dtype), str(dtype)))
            block = torch.as_tensor(inputs["block"], dtype=dtype, device=device)
            w = torch.as_tensor(inputs["mask"], device=device).to(dtype)
            mean = (block * w[..., None]).sum(1) / w.sum(1)[:, None]
            return mean.cpu().numpy(), mean.mean(0).cpu().numpy()


        def step_ops(config, profile):
            s = config["shape"]
            m, r, t = s["models"], s["realisations"], s["t"]
            return 3.0 * m * r * t + 3.0 * profile["n_optim_nits"] * m * t


        def left_at_start(config, args, kwargs, result, which):
            block = args[0]
            start = block.new_zeros((block.shape[0], block.shape[-1]))
            if which == "all":
                return start
            if kwargs["batch"] != {"first": 0, "last": 1}[which]:
                return result
            m = start.shape[0]
            return torch.where((torch.arange(m) < m // 2)[:, None], result, start)


        def half_models(args, kwargs):
            means, mask = args
            keep = (torch.arange(mask.shape[0]) < mask.shape[0] // 2).to(mask.dtype)
            return (means, mask * keep), kwargs
    ''',
    "configs/toyf64.json": {
        "name": "toyf64", "source": "a throwaway configuration", "entry": "toy_halving",
        "generator": "toy_noise", "dtype": "float64", "reduced": [],
        "shape": {"models": 4, "realisations": 4, "t": 6}, "data": {"sd": 0.5}},
    "traffic/halving.json": {
        "name": "halving", "toy_halving": {"n_optim_nits": 60, "dba_iterations": 1},
        "warmup": {"n_optim_nits": 2}},
    "workloads/toyf64.halving.json": {
        "name": "toyf64.halving", "config": "toyf64", "traffic": "halving", "pool": 2,
        "why": "a throwaway cell in float64",
        "checks": {"model_mean_max": {"output": "model_mean", "statistic": "max", "limit": 1e-9},
                   "ensemble_mean_max": {"output": "ensemble_mean", "statistic": "max",
                                         "limit": 1e-9}}},
}
F64_FILES["generators/toy_noise.py"] = NEW_FILES["generators/toy_noise.py"]

F64_PROBE = '''
import json, math, sys
sys.path.insert(0, ".")
sys.path.append(sys.argv[1])  # the port, from the repository
import torch
from portbench import control, faults, run, work
from portbench.tests.test_portbench_harness import stub_context

cpu, seed = torch.device("cpu"), 2 ** 31 + 5
cell = run.Cell.named("toyf64.halving")
entry = work.entry_of(cell.config)
out = {"step_ops": work.step_ops(cell.config, cell.profile),
       "entry_ops": entry.step_ops(cell.config, cell.profile),
       "kernels": [work.kernel_step_seconds(k, cell.config, cell.profile)
                   for k in ("chol_solve", "tri_inv")], "metrics": {}}
ctx = stub_context(cell, False)
out["mfu"] = run.read_metric("step_mfu", ctx)
out["mfu_want"] = 100.0 * out["entry_ops"] / (ctx.step_s * work.FP64_FLOPS)
work.PEAK_FLOPS["float32"] = 1.0  # a float64 cell does not read float32's peak ...
out["mfu_f32_moved"] = run.read_metric("step_mfu", ctx)
work.PEAK_FLOPS["float64"] = 2.0 * work.FP64_FLOPS  # ... but float64's
out["mfu_f64_doubled"] = run.read_metric("step_mfu", ctx)
work.PEAK_FLOPS.update(float32=work.FP32_FLOPS, float64=work.FP64_FLOPS)
for traced in (False, True):
    for m in cell.end_to_end + cell.per_layer:
        value = run.read_metric(m["name"], stub_context(cell, traced))
        assert value is None or math.isfinite(value), (m["name"], value)
        out["metrics"][f"{m['name']}:{traced}"] = value

got = control.readings(cell, seed, cpu, program=True)
out["control"], out["program"], out["seen"] = got["control"], got["program"], list(entry.SEEN)

result, _ = run.run_cell(cell, seed, 0.2, True, cpu)
out["correct"] = result["correct"]
out["faults"] = {}
plants = {"unchanged_fit": "fit", "half_first_batch_unfitted": "fit",
          "half_last_batch_unfitted": "fit", "half_models_left_out": "tail",
          "answer_altered": "tail"}
for name, kind in plants.items():
    module, attr = faults.site(cell.config, kind)
    original = getattr(module, attr)
    with (faults.answer_altered(cell.config, "ensemble_mean", 2e-9) if name == "answer_altered"
          else faults.planted(name, cell.config)):
        at_site = getattr(module, attr) is not original
        result, _ = run.run_cell(cell, seed, 0.2, False, cpu)
    out["faults"][name] = dict(at_site=at_site, restored=getattr(module, attr) is original,
                               correct=result["correct"], checks=result["checks"])
print(json.dumps(out))
'''


def test_a_float64_cell_of_another_emulator_needs_only_new_files(tmp_path):
    copy_with(tmp_path, F64_FILES,
              {"name": "toyf64", "source": "a throwaway configuration",
               "file": "portbench/configs/toyf64.json", "reduced": [],
               "why": "a throwaway configuration in float64"},
              {"name": "toyf64.halving", "config": "toyf64", "traffic": "halving", "chips": 1,
               "why": "a throwaway cell in float64"})
    out = probe(tmp_path, F64_PROBE)
    # The entry's own count, and no exact-GP kernel roofline.
    assert out["step_ops"] == out["entry_ops"] == 3.0 * 4 * 4 * 6 + 3.0 * 60 * 4 * 6
    assert out["kernels"] == [None, None]
    # step_mfu over the float64 peak.
    assert out["mfu"] == out["mfu_want"] == out["mfu_f32_moved"]
    assert out["mfu_f64_doubled"] == out["mfu"] / 2.0
    assert out["metrics"]["step_mfu:True"] > 0.0
    # The control: the reference in float32 on float32 inputs; it misses.
    assert out["seen"] == [["float64", "torch.float64"], ["float32", "torch.float32"]]
    assert all(0.0 < v for v in out["control"].values())
    assert any(v > 1e-9 for v in out["control"].values()), out["control"]
    assert all(v <= 1e-9 for v in out["program"].values()), out["program"]
    # A sound run is correct; each fault, planted at the entry's sites, is not.
    assert out["correct"]
    for name, fault in out["faults"].items():
        assert fault["at_site"] and fault["restored"], name
        assert not fault["correct"], (name, fault["checks"])
