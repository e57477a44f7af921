"""The port's own spans and counters, for the per-layer metrics that read them.

``run.py --trace 1`` profiles one step of the sampled pool entry with the
port's tracer off, then calls :func:`traced_steps`, which runs two more
steps of the same entry's tensors, before the reference and while the
allocator is still warm, and sets three fields on the context:

(a) a step with the port's tracer on (``utils.profiling.recording``) and no
    profiler: ``ctx.program_spans``, its span records, each timed by two
    CUDA events on the stream its work went to;
(b) a step with the tracer on under ``torch.profiler``, after
    ``reset_launch_counts``: ``ctx.program_trace``, a
    :class:`portbench.trace.Trace` whose host operations hold each span as a
    ``bet.<name>`` range, and ``ctx.fit_steps``, the port's optimiser steps
    by optimiser (``fit_step_counts``).

Each step's answers are held bit for bit to the window's answers of the same
entry; a step whose answers differ leaves its fields None, and the log says
so.  A program without the tracer (or the counter) leaves them None, and
every reader then finds nothing.  The log also gives the tracer's cost (step
(a) against the window's ``step_s``, step (b) against the profiled step),
the card's idle time inside each span's own interval in step (b), and its ten
longest idle gaps named by the innermost span under way.
"""

from __future__ import annotations

import importlib
import re
import sys
import time
import typing as tp

import numpy as np

from portbench import trace as trace_mod

FIT_LOOP = "bet.fit.loop"
# The host calls that launch work on the card: kernel launches through the
# ``cuda*`` and the ``cu*`` APIs, and a CUDA graph's replay (one call a replay).
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx", "cudaGraphLaunch"})
_VERSION = re.compile(r"_(v\d+|ptsz)$")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _union(intervals) -> tp.List[tp.Tuple[float, float]]:
    merged: tp.List[tp.Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _length(intervals) -> float:
    return sum(hi - lo for lo, hi in intervals)


def _overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _minus(interval, holes) -> tp.List[tp.Tuple[float, float]]:
    """``interval`` less the merged intervals ``holes``."""
    lo, hi = interval
    out = []
    for h_lo, h_hi in holes:
        if h_lo > lo:
            out.append((lo, min(h_lo, hi)))
        lo = max(lo, h_hi)
        if lo >= hi:
            break
    if lo < hi:
        out.append((lo, hi))
    return [(a, b) for a, b in out if b > a]


def _ranges(trace, name: str) -> tp.List[tp.Tuple[float, float]]:
    """The host intervals of the operations called ``name``."""
    return [(float(s), float(e)) for n, s, e in zip(trace.host_names, trace.host_start,
                                                    trace.host_end) if n == name]


def _spans(trace):
    """Every ``bet.*`` range: (name, start, end)."""
    return [(n, float(s), float(e)) for n, s, e in zip(trace.host_names, trace.host_start,
                                                       trace.host_end) if n.startswith("bet.")]


def launches_in(trace, name: str = FIT_LOOP) -> tp.Optional[int]:
    """Launch calls (``LAUNCH_CALLS``) that start inside a ``name`` range,
    each counted once: a ``cuLaunchKernel*`` made inside a
    ``cudaLaunchKernel*`` call is part of it.  None where the trace has no such range."""
    inside = _union(_ranges(trace, name))
    if not inside:
        return None
    calls = sorted((float(s), float(e)) for n, s, e in zip(trace.host_names, trace.host_start,
                                                           trace.host_end)
                   if _VERSION.sub("", n) in LAUNCH_CALLS)
    count, outer_end, k = 0, -np.inf, 0
    for start, end in calls:
        if start < outer_end:
            continue
        outer_end = end
        while k < len(inside) and inside[k][1] <= start:
            k += 1
        if k < len(inside) and inside[k][0] <= start:
            count += 1
    return count


def idle_in(trace, name: str = FIT_LOOP) -> tp.Optional[tp.Tuple[float, float]]:
    """(idle, span) seconds: the union of the ``name`` ranges, and the part
    of it in which the card ran nothing.  None where there is no range."""
    inside = _union(_ranges(trace, name))
    if not inside:
        return None
    span = _length(inside)
    return span - _overlap(inside, trace.busy_intervals()), span


def self_idle(trace) -> tp.Dict[str, tp.Tuple[float, float]]:
    """For each span name: (self, idle) seconds, self being the parts of its
    ranges that no other ``bet.*`` range inside them covers, and idle the
    part of those in which the card ran nothing."""
    spans, busy = _spans(trace), trace.busy_intervals()
    out: tp.Dict[str, tp.Tuple[float, float]] = {}
    for i, (name, start, end) in enumerate(spans):
        children = _union((s, e) for j, (_, s, e) in enumerate(spans)
                          if j != i and start <= s and e <= end)
        own = _minus((start, end), children)
        s_self, s_idle = out.get(name, (0.0, 0.0))
        out[name] = (s_self + _length(own), s_idle + _length(own) - _overlap(own, busy))
    return out


def named_gaps(trace, n: int = 10):
    """The ``n`` longest stretches in which the card ran nothing, each named
    by the innermost ``bet.*`` range under way when it began."""
    spans = _spans(trace)
    gaps, prev = [], 0.0
    for lo, hi in trace.busy_intervals():
        if lo > prev:
            gaps.append((prev, lo - prev))
        prev = max(prev, hi)
    if trace.window_s > prev:
        gaps.append((prev, trace.window_s - prev))
    out = []
    for start, length in sorted(gaps, key=lambda g: -g[1])[:n]:
        under = [(s, name) for name, s, e in spans if s <= start < e]
        out.append([max(under)[1] if under else "outside every bet. span", length])
    return out


def _host(outputs):
    return tuple(a.detach().cpu().numpy() for a in outputs)


def _same(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def traced_steps(ctx, bt, entry, t, answers, device):
    """Steps (a) and (b) of the module docstring on the entry's tensors
    ``t``, whose answers in the window were ``answers``: sets
    ``ctx.program_spans``, ``ctx.program_trace`` and ``ctx.fit_steps``."""
    from torch.profiler import ProfilerActivity, profile

    profiling = importlib.import_module("bayesian_ensembling_tpu_torch.utils.profiling")
    recording = getattr(profiling, "recording", None)
    fit_step_counts = getattr(bt, "fit_step_counts", None)
    ctx.program_spans = ctx.program_trace = ctx.fit_steps = None
    if recording is None:
        log("[spans] the program has no span tracer: the span metrics are left out")
        return
    config, profile_ = ctx.cell.config, ctx.cell.profile

    with recording() as rec_a:
        t0 = time.perf_counter()
        out_a = _host(entry.step(bt, t, config, profile_))
        wall_a = time.perf_counter() - t0
    same_a = _same(out_a, answers)
    by_name: tp.Dict[str, float] = {}
    for s in rec_a.spans:
        if s.device_ms is not None:
            by_name[s.name] = by_name.get(s.name, 0.0) + s.device_ms
    log(f"[spans] (a) tracer on: {wall_a:.6f} s against the window's step_s {ctx.step_s:.6f} s "
        f"({100.0 * (wall_a / ctx.step_s - 1.0):+.2f}%); {len(rec_a.spans)} spans; device ms "
        + (", ".join(f"{k} {v:.4f}" for k, v in by_name.items()) or "not measured (no card)")
        + ("; its answers equal the window's bit for bit" if same_a else
           "; its answers differ from the window's, so its metrics are left out"))
    if same_a:
        ctx.program_spans = rec_a.spans

    bt.reset_launch_counts()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    with profile(activities=activities) as prof:
        with recording() as rec_b:
            t0 = time.perf_counter()
            out_b = _host(entry.step(bt, t, config, profile_))
            wall_b = time.perf_counter() - t0
    steps = fit_step_counts() if fit_step_counts is not None else None
    raw = trace_mod.from_profiler(prof, wall_b)
    # The profiler also lays each range over the card's timeline; that is
    # no work of the card.
    program = trace_mod.Trace(window_s=raw.window_s,
                              device=[d for d in raw.device if not d[0].startswith("bet.")],
                              host_names=raw.host_names, host_start=raw.host_start,
                              host_end=raw.host_end)
    same_b = _same(out_b, answers)
    log(f"[spans] (b) tracer on under torch.profiler: {wall_b:.6f} s against the profiled "
        f"step's {ctx.trace.window_s:.6f} s ({100.0 * (wall_b / ctx.trace.window_s - 1.0):+.2f}%);"
        f" {len(rec_b.spans)} spans; fit steps {steps}; launches {bt.launch_counts()}"
        + ("; its answers equal the window's bit for bit" if same_b else
           "; its answers differ from the window's, so its metrics are left out"))
    launches, idle = launches_in(program), idle_in(program)
    log(f"[spans] (b) inside {FIT_LOOP}: {launches} launch calls over "
        f"{None if steps is None else sum(steps.values())} optimiser steps; card idle "
        + ("n/a" if idle is None else f"{idle[0] * 1e3:.3f} of {idle[1] * 1e3:.3f} ms")
        + f"; in the whole step {launches_in(program, 'bet.step')} launch calls, "
        f"{len(program.device)} device activities")
    log("[spans] (b) self time and card idle inside it, ms: " + "; ".join(
        f"{k} {v[0] * 1e3:.3f} idle {v[1] * 1e3:.3f}" for k, v in self_idle(program).items()))
    log("[spans] (b) longest idle gaps: " + "; ".join(
        f"{name} {length * 1e3:.3f} ms" for name, length in named_gaps(program)))
    if same_b:
        ctx.program_trace, ctx.fit_steps = program, steps


def span_ms(ctx, name: str) -> tp.Optional[float]:
    """Device milliseconds of the ``name`` spans of step (a), summed over its
    collections; None where there are none or they ran on the CPU."""
    spans = ctx.program_spans
    if not spans:
        return None
    root = next((s.root for s in spans if s.name == "step"), None)
    times = [s.device_ms for s in spans if s.name == name and s.root == root]
    if not times or any(ms is None for ms in times):
        return None
    return float(sum(times))


def launches_per_iter(ctx) -> tp.Optional[float]:
    """Launch calls inside the optimiser loops of step (b) over its
    optimiser steps."""
    program, steps = ctx.program_trace, ctx.fit_steps
    if program is None or not program.device or not steps or sum(steps.values()) <= 0:
        return None
    launches = launches_in(program)
    return None if launches is None else launches / sum(steps.values())


def idle_pct(ctx) -> tp.Optional[float]:
    """The share of step (b)'s optimiser loops in which the card ran
    nothing, in percent."""
    program = ctx.program_trace
    if program is None or not program.device:
        return None
    idle = idle_in(program)
    return None if idle is None or idle[1] <= 0.0 else 100.0 * idle[0] / idle[1]
