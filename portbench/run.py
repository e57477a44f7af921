"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name: ``portbench/workloads/<cell>.json`` names its
configuration (``portbench/configs/<config>.json``: shapes, data, the port's
entry) and its traffic (``portbench/traffic/<traffic>.json``: the fit
profile for each entry), and ``BENCHMARK.json`` lists the metrics, each read
by ``portbench/metrics/<metric>.py``.

A run makes a pool of distinct input sets from the seed, loads the port,
builds its kernels (once a checkout: ``build/torch_kernels/``) and warms up
every shape with a short fit (set-up), then runs whole steps of the port's
entry in a closed loop for ``--seconds``, each step ended when its answers
are on the host, every step started in the window finished.  One pool
entry is drawn from the seed among those the window finished.  With
``--trace 1`` the run then repeats that entry's step three times: once under
``torch.profiler`` with the port's tracer off, and twice with it on
(``portbench/program_spans.py``), each held bit for bit to the window's
answers.  Last, with the program's state freed, the plain reference
(``portbench/reference``) works out that entry's answers in float64 from the
same inputs, and every answer the window gave for it is compared with it.

Standard error carries the log, a ``[phases]`` line with the seconds of
set-up, window, traced steps, reference and readers, and last the numbers
compared beside their limits; the last line of standard output is the
result.  Without a CUDA device, with fewer than the cell asks for, with TF32
switched on, or with JAX or the JAX package loaded, the run prints no result
and exits 2.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import typing as tp  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

# Top-level module names that may not be loaded in the process that prints
# a result (compared whole: the port's name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "bayesian_ensembling_tpu")
GIB = 2 ** 30


class Refused(RuntimeError):
    """A run that may not print a result."""


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """What one cell is made of, each part found by name."""

    name: str
    chips: int
    workload: dict
    config: dict
    traffic: dict
    end_to_end: tp.List[dict]
    per_layer: tp.List[dict]

    @property
    def profile(self) -> dict:
        return self.traffic[self.config["entry"]]

    @property
    def warmup_profile(self) -> dict:
        """The profile with the traffic's short step counts: the same
        shapes and kernels, a few optimiser steps."""
        short = {k: v for k, v in self.traffic["warmup"].items() if k in self.profile}
        return dict(self.profile, **short)

    @classmethod
    def named(cls, name: str, root: Path = ROOT) -> "Cell":
        bench = _json(root / "BENCHMARK.json")
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if not entries:
            raise Refused(f"BENCHMARK.json has no cell named {name!r}")
        entry = entries[0]
        workload = _json(BENCH / "workloads" / f"{name}.json")
        for key in ("config", "traffic"):
            if workload[key] != entry[key]:
                raise Refused(f"{name}: {key} is {entry[key]!r} in BENCHMARK.json but "
                              f"{workload[key]!r} in its workload file")

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        return cls(name=name, chips=entry["chips"], workload=workload,
                   config=_json(BENCH / "configs" / f"{entry['config']}.json"),
                   traffic=_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
                   end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


@dataclasses.dataclass
class Context:
    """What the metric readers read (``portbench/metrics``)."""

    cell: Cell
    setup_s: float
    step_s: float
    peak_window_bytes: int
    trace: tp.Any = None
    # Set by ``program_spans.traced_steps`` in a traced run.
    program_spans: tp.Any = None
    program_trace: tp.Any = None
    fit_steps: tp.Optional[tp.Dict[str, int]] = None


def read_metric(name: str, ctx: Context):
    """The value of metric ``name`` from its reader, or None where the
    reader found nothing to read."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def _nvidia_smi() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True)
        return "; ".join(proc.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as err:
        return f"not read ({err})"


def _tf32_flags(torch) -> dict:
    return {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def _tf32_off(torch) -> bool:
    flags = _tf32_flags(torch)
    return (not flags["matmul.allow_tf32"] and not flags["cudnn.allow_tf32"]
            and flags["float32_matmul_precision"] == "highest")


def require_devices(torch, chips: int):
    """The card of a measured run: refuses without CUDA or with fewer devices
    than the cell asks for, and logs what the numbers were measured on."""
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: a measured run needs the card and never falls back to "
                      "the CPU")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} devices, {torch.cuda.device_count()} found")
    log(f"[device] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} (using {chips}); "
        f"nvidia-smi name, power.limit: {_nvidia_smi()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 {_tf32_flags(torch)}")
    return torch.device("cuda")


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(outputs) -> tp.Tuple[np.ndarray, ...]:
    return tuple(a.detach().cpu().numpy() for a in outputs)


def _finite(outputs) -> bool:
    return all(np.isfinite(a).all() for a in outputs)


def _sampled(seed: int, finished: tp.Sequence[int]) -> int:
    """The pool entry whose answers are compared: drawn from the seed among
    those the window finished."""
    rng = np.random.default_rng([seed % 2 ** 64, 2 ** 32])
    return sorted(finished)[int(rng.integers(len(finished)))]


# How a compared number is taken from the pointwise gaps |program - reference|
# of one output of one step: the widest gap, the median gap, or the gap that
# a quarter of the points stay within, each along the last axis.
STATISTICS = {"max": lambda d: np.max(d, axis=-1), "median": lambda d: np.median(d, axis=-1),
              "p25": lambda d: np.quantile(d, 0.25, axis=-1)}


def statistic(check: dict, diff: np.ndarray) -> float:
    """``check``'s statistic of the gaps ``diff``: over all of them, or with
    ``"row_rank": k`` over each row (the leading axis: a scenario, a cell, a
    model) alone, and then the k-th largest of the rows' readings (1: the
    largest), so that a fault confined to k rows or more reads as it does
    in those rows."""
    rank = check.get("row_rank")
    rows = diff.reshape(diff.shape[0] if rank else 1, -1)
    return float(np.sort(STATISTICS[check["statistic"]](rows))[-(rank or 1)])


def compared_numbers(checks: dict, outputs: tp.Sequence[str], got, want) -> tp.Dict[str, float]:
    """Each compared number of one step's answers ``got`` against the
    reference's ``want``; a non-finite answer reads +inf."""
    values = {}
    for name, check in checks.items():
        j = outputs.index(check["output"])
        diff = np.abs(got[j].astype(np.float64) - want[j])
        values[name] = statistic(check, diff) if np.isfinite(diff).all() else float("inf")
    return values


def _profiled(torch, fn, device):
    """``fn()`` once under ``torch.profiler``: (outputs, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as trace_mod

    _sync(torch, device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = _host(fn())
        window = time.perf_counter() - t0
    return out, trace_mod.from_profiler(prof, window)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device):
    """One run of ``cell`` on ``device``; returns ``(result, checks)``."""
    import torch

    from portbench.traffic import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    config, profile = cell.config, cell.profile
    entry = importlib.import_module(f"portbench.entries.{config['entry']}")
    dtype = getattr(torch, config["dtype"])
    pool_size = cell.workload["pool"]

    inputs = generate.pool(config, seed, pool_size)
    import bayesian_ensembling_tpu_torch as bt

    tensors = [entry.tensors(x, dtype, device) for x in inputs]
    warm_start = time.perf_counter()
    _host(entry.step(bt, tensors[0], config, cell.warmup_profile))
    _sync(torch, device)
    build = getattr(bt._build, "build_info", {})
    log(f"[setup] inputs {pool_size} sets; kernels' library "
        f"{build.get('path', 'not loaded')} ready in {build.get('seconds', 0.0):.3f} s; warm-up "
        f"step ({cell.warmup_profile}) {time.perf_counter() - warm_start:.3f} s")
    setup_s = time.perf_counter() - _START
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    answers: tp.Dict[int, list] = {}
    durations, cpu = [], []
    window_start = time.perf_counter()
    while time.perf_counter() - window_start < seconds:
        i = len(durations) % pool_size
        t0, c0 = time.perf_counter(), time.thread_time()
        out = _host(entry.step(bt, tensors[i], config, profile))
        durations.append(time.perf_counter() - t0)
        cpu.append(time.thread_time() - c0)
        answers.setdefault(i, []).append(out)
    window_end = time.perf_counter()
    step_s = (window_end - window_start) / len(durations)
    peak_window = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"[window] {len(durations)} steps in {window_end - window_start:.3f} s: step_s "
        f"{step_s:.6f}; per step min {min(durations):.6f} median "
        f"{float(np.median(durations)):.6f} max {max(durations):.6f} s "
        f"({' '.join(f'{d:.4f}' for d in durations[:100])}); the main thread's CPU time a "
        f"step ({' '.join(f'{c:.4f}' for c in cpu[:100])}); peak "
        f"{peak_window / GIB:.6f} GiB in the window, {setup_peak / GIB:.6f} GiB in set-up")
    if device.type == "cuda" and not _tf32_off(torch):
        raise Refused(f"TF32 was switched on during the run: {_tf32_flags(torch)}")
    k = _sampled(seed, answers)

    ctx = Context(cell=cell, setup_s=setup_s, step_s=step_s, peak_window_bytes=peak_window)
    traced_start = time.perf_counter()
    if trace:
        from portbench import program_spans

        bt.reset_launch_counts()
        out, ctx.trace = _profiled(torch, lambda: entry.step(bt, tensors[k], config, profile),
                                   device)
        log(f"[trace] the profiled step's counters: launches {bt.launch_counts()}, routes "
            f"{bt.route_counts()}")
        log(f"[trace] profiled step of pool entry {k}: {ctx.trace.window_s:.6f} s (untraced "
            f"step_s {step_s:.6f}), {len(ctx.trace.device)} device activities, busy "
            f"{ctx.trace.busy_s:.6f} s")
        if not all(np.array_equal(a, b) for a, b in zip(out, answers[k][0])):
            log("[trace] the profiled step's answers differ from the window's")
        program_spans.traced_steps(ctx, bt, entry, tensors[k], answers[k][0], device)
    traced_s = time.perf_counter() - traced_start

    del tensors
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref_start = time.perf_counter()
    reference = entry.reference(
        {key: a.astype(np.float64) if a.dtype != bool else a for key, a in inputs[k].items()},
        config, profile, device, torch.float64)
    spec = cell.workload["checks"]
    numbers = [compared_numbers(spec, entry.OUTPUTS, out, reference) for out in answers[k]]
    checks = [(name, max(n[name] for n in numbers), c["limit"]) for name, c in spec.items()]
    log(f"[check] the reference's answers of pool entry {k} in "
        f"{time.perf_counter() - ref_start:.3f} s; {len(numbers)} of the window's answers compared")
    unfinished = sum(not _finite(out) for outs in answers.values() for out in outs)
    wrong = sum(any(n[name] > c["limit"] for name, c in spec.items()) for n in numbers)
    correct = unfinished == 0 and all(value <= limit for _, value, limit in checks)

    ref_s = time.perf_counter() - ref_start

    readers_start = time.perf_counter()
    kinds = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in kinds:
        value = read_metric(m["name"], ctx)
        if value is None:
            log(f"[metric] {m['name']}: nothing to read, left out")
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(durations),
        "failed": int(unfinished + wrong),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": int(max(setup_peak, peak_window))},
    }
    if trace:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_device_ops(),
                               "idle_gaps": ctx.trace.longest_idle_gaps()}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    log(f"[phases] setup {setup_s:.3f} s, window {window_end - window_start:.3f} s, traced steps "
        f"{traced_s:.3f} s, reference {ref_s:.3f} s, readers "
        f"{time.perf_counter() - readers_start:.3f} s; {time.perf_counter() - _START:.3f} s "
        "since the process started")
    return result, checks


def loaded_forbidden() -> tp.List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    try:
        cell = Cell.named(args.workload)
        import torch

        torch.set_num_threads(1)
        device = require_devices(torch, cell.chips)
        result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
        found = loaded_forbidden()
        if found:
            raise Refused(f"modules of JAX or the JAX package were loaded: {found}")
    except Refused as err:
        log(f"portbench: refused: {err}")
        return 2
    for name, value, limit in checks:
        log(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
