"""The readers of the port's own spans and counters
(``portbench/program_spans.py``): ``span.{dba,fit,posterior,tail}_ms``,
``fit.launches_per_iter`` and ``fit.idle_pct`` on synthetic span records
and a synthetic ``Trace``, None where there is nothing to read, and a
traced run on the CPU at a tiny size, where no device metric is read.
"""

from __future__ import annotations

import copy
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench import program_spans, run  # noqa: E402
from portbench.trace import Trace  # noqa: E402

SPAN_METRICS = ("span.dba_ms", "span.fit_ms", "span.posterior_ms", "span.tail_ms")
PROGRAM_METRICS = SPAN_METRICS + ("fit.launches_per_iter", "fit.idle_pct")


def ctx_with(spans=None, trace=None, steps=None):
    """A context whose program fields the traced steps have set."""
    return types.SimpleNamespace(trace=object(), program_spans=spans, program_trace=trace,
                                 fit_steps=steps)


def record(name, id_, root, device_ms):
    return types.SimpleNamespace(name=name, id=id_, root=root, device_ms=device_ms)


def two_collections(device_ms=1.0):
    """One step's spans: two collections, then the tail; and a second step
    (another root) whose spans must not be counted."""
    spans = [record("step", 1, 1, 100.0)]
    for k, base in enumerate((2, 6)):
        spans += [record("dba", base, 1, device_ms * (k + 1)),
                  record("fit", base + 1, 1, 10.0 * (k + 1)),
                  record("fit.loop", base + 2, 1, 9.0 * (k + 1)),
                  record("posterior", base + 3, 1, 0.5 * (k + 1))]
    spans += [record("tail", 10, 1, 0.25), record("step", 11, 11, 50.0),
              record("fit", 12, 11, 40.0)]
    return spans


def test_the_span_readers_sum_the_step_s_collections():
    ctx = ctx_with(spans=two_collections())
    assert run.read_metric("span.dba_ms", ctx) == pytest.approx(3.0)
    assert run.read_metric("span.fit_ms", ctx) == pytest.approx(30.0)
    assert run.read_metric("span.posterior_ms", ctx) == pytest.approx(1.5)
    assert run.read_metric("span.tail_ms", ctx) == pytest.approx(0.25)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_span_reader_finds_nothing_without_spans_or_off_the_card(name):
    assert run.read_metric(name, ctx_with()) is None
    assert run.read_metric(name, ctx_with(spans=[])) is None
    cpu = [record(s.name, s.id, s.root, None) for s in two_collections()]
    assert run.read_metric(name, ctx_with(spans=cpu)) is None
    assert run.read_metric(name, ctx_with(spans=[record("step", 1, 1, 5.0)])) is None


def synthetic_trace():
    """Two optimiser loops, [1, 2) and [3, 4), under one fit [0.9, 4.1);
    launch calls in and out of them (one a ``cuLaunchKernel`` inside a
    ``cudaLaunchKernel``'s call, one a graph replay, one with a version suffix); the card
    busy over [1, 1.5), [1.8, 3.25) and [3.9, 4.5)."""
    host = [("bet.step", 0.0, 5.0), ("bet.fit", 0.9, 4.1), ("bet.fit.loop", 1.0, 2.0),
            ("bet.fit.loop", 3.0, 4.0),
            ("cudaLaunchKernel", 1.1, 1.2), ("cuLaunchKernel", 1.12, 1.15),
            ("cudaLaunchKernel", 1.5, 1.6), ("cudaGraphLaunch", 3.5, 3.6),
            ("cudaLaunchKernelExC_v11060", 3.7, 3.8), ("cudaLaunchKernel", 2.5, 2.6),
            ("cudaLaunchKernel", 0.2, 0.3), ("aten::mul", 1.3, 1.4),
            ("bet.tail", 4.5, 4.9)]
    device = [("kernel_a", 1.0, 0.5), ("kernel_b", 1.8, 1.45), ("kernel_c", 3.9, 0.6)]
    return Trace(window_s=5.0, device=device, host_names=[h[0] for h in host],
                 host_start=np.array([h[1] for h in host]),
                 host_end=np.array([h[2] for h in host]))


def test_launches_per_iter_counts_each_launch_call_once_inside_the_loops():
    ctx = ctx_with(trace=synthetic_trace(), steps={"adam": 3, "bfgs": 1, "lbfgs": 0})
    # 1.1 (its nested cuLaunchKernel not again), 1.5, 3.5 (a replay), 3.7; not 2.5 or 0.2.
    assert program_spans.launches_in(ctx.program_trace) == 4
    assert run.read_metric("fit.launches_per_iter", ctx) == pytest.approx(1.0)


def test_fit_idle_pct_is_the_idle_share_of_the_loops():
    ctx = ctx_with(trace=synthetic_trace(), steps={"adam": 4})
    # Loops 2.0 s; busy inside them [1, 1.5), [1.8, 2), [3, 3.25), [3.9, 4): 1.05 s.
    assert program_spans.idle_in(ctx.program_trace) == pytest.approx((0.95, 2.0))
    assert run.read_metric("fit.idle_pct", ctx) == pytest.approx(47.5)


def _no_loop(trace):
    keep = [i for i, n in enumerate(trace.host_names) if n != "bet.fit.loop"]
    return Trace(trace.window_s, trace.device, [trace.host_names[i] for i in keep],
                 trace.host_start[keep], trace.host_end[keep])


@pytest.mark.parametrize("trace, steps", [
    (None, {"adam": 4}),
    ("no_device", {"adam": 4}),
    ("no_loop", {"adam": 4}),
    ("trace", None),
    ("trace", {"adam": 0}),
])
def test_the_loop_readers_find_nothing_where_there_is_nothing_to_read(trace, steps):
    full = synthetic_trace()
    trace = {None: None, "trace": full, "no_loop": _no_loop(full),
             "no_device": Trace(full.window_s, [], full.host_names, full.host_start,
                                full.host_end)}[trace]
    ctx = ctx_with(trace=trace, steps=steps)
    assert run.read_metric("fit.launches_per_iter", ctx) is None
    if trace is not full:  # the idle share needs no step count
        assert run.read_metric("fit.idle_pct", ctx) is None


def test_self_idle_and_the_gaps_are_put_down_to_the_innermost_span():
    trace = synthetic_trace()
    own = program_spans.self_idle(trace)
    # fit's own: [0.9, 1), [2, 3) and [4, 4.1), the card busy in all but [0.9, 1).
    assert own["bet.fit"][0] == pytest.approx(1.2)
    assert own["bet.fit"][1] == pytest.approx(1.2 - 1.0 - 0.1)
    assert own["bet.fit.loop"] == pytest.approx((2.0, 0.95))
    assert own["bet.step"][0] == pytest.approx(5.0 - 3.2 - 0.4)
    gaps = program_spans.named_gaps(trace, n=3)
    assert gaps == [["bet.step", pytest.approx(1.0)], ["bet.fit.loop", pytest.approx(0.65)],
                    ["bet.tail", pytest.approx(0.5)]]


def test_a_program_without_the_tracer_gives_nothing_and_runs_nothing(monkeypatch):
    import bayesian_ensembling_tpu_torch as bt
    import torch
    from bayesian_ensembling_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")

    class Entry:
        calls = 0

        @classmethod
        def step(cls, *args):
            cls.calls += 1
            return ()

    cell = run.Cell.named("gridded-5deg.fast")
    ctx = run.Context(cell=cell, setup_s=1.0, step_s=1.0, peak_window_bytes=0,
                      trace=synthetic_trace(), program_spans=[], program_trace=object(),
                      fit_steps={"adam": 1})
    program_spans.traced_steps(ctx, bt, Entry, (), (), torch.device("cpu"))
    assert Entry.calls == 0
    assert (ctx.program_spans, ctx.program_trace, ctx.fit_steps) == (None, None, None)
    for name in PROGRAM_METRICS:
        assert run.read_metric(name, ctx) is None


def test_a_run_without_a_trace_gathers_nothing():
    ctx = run.Context(cell=run.Cell.named("gridded-5deg.fast"), setup_s=1.0, step_s=1.0,
                      peak_window_bytes=0)
    assert (ctx.program_spans, ctx.program_trace, ctx.fit_steps) == (None, None, None)
    for name in PROGRAM_METRICS:
        assert run.read_metric(name, ctx) is None


def test_a_traced_run_on_the_cpu_runs_the_traced_steps_and_reads_no_device_metric(capsys,
                                                                                 monkeypatch):
    import importlib

    import torch

    cell = copy.deepcopy(run.Cell.named("gridded-5deg.fast"))
    entry = importlib.import_module(f"portbench.entries.{cell.config['entry']}")
    cell.config["shape"].update(entry.TINY)
    cell.traffic[cell.config["entry"]].update(n_optim_nits=4)
    cell.workload["pool"] = 1
    calls = []
    step = entry.step
    monkeypatch.setattr(entry, "step", lambda *a: calls.append(1) or step(*a))
    result, _ = run.run_cell(cell, 2 ** 31 + 5, 0.2, True, torch.device("cpu"))
    assert result["correct"]
    # The warm-up, the window's steps, then the profiled step, (a) and (b).
    assert len(calls) == 1 + result["attempted"] + 3
    assert not set(PROGRAM_METRICS) & set(result["metrics"])
    err = capsys.readouterr().err
    assert "[spans] (a) tracer on" in err and "[spans] (b) tracer on under torch.profiler" in err
    assert err.count("equal the window's bit for bit") == 2
    assert "fit steps {'adam': 0, 'bfgs': 4, 'lbfgs': 0}" in err
    phases = next(line for line in err.splitlines() if line.startswith("[phases]"))
    for phase in ("setup", "window", "traced steps", "reference", "readers"):
        assert f" {phase} " in phases
