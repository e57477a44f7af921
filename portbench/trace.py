"""Reduce a ``torch.profiler`` trace to what the per-layer metrics read.

Device activity (kernels, copies, sets) and host operations are read from
the profiler's own event list; the device's busy time is the union of the
intervals of its activity (copy of ``chip_smoke._busy_share``'s
arithmetic), and each long idle gap is named by the innermost host
operation under way when it began.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np


@dataclasses.dataclass
class Trace:
    """One profiled window: device activity ``(name, start_s, seconds)`` and
    host operations, times relative to the window's start."""

    window_s: float
    device: tp.List[tp.Tuple[str, float, float]]
    host_names: tp.List[str]
    host_start: np.ndarray
    host_end: np.ndarray

    def busy_intervals(self) -> tp.List[tp.Tuple[float, float]]:
        merged: tp.List[tp.Tuple[float, float]] = []
        for lo, hi in sorted((s, s + d) for _, s, d in self.device):
            if merged and lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals())

    def seconds_of(self, pattern: str) -> float:
        """Device seconds of the activities whose name holds ``pattern``."""
        return sum(d for name, _, d in self.device if pattern in name)

    def top_device_ops(self, n: int = 10):
        totals: tp.Dict[str, float] = {}
        for name, _, d in self.device:
            totals[name] = totals.get(name, 0.0) + d
        return [[_short(k), v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]

    def longest_idle_gaps(self, n: int = 10):
        """The ``n`` longest stretches of the window in which the device ran
        nothing, each named by the innermost host operation under way when it
        began ("no host operation" where none was)."""
        edges, prev = [], 0.0
        for lo, hi in self.busy_intervals():
            if lo > prev:
                edges.append((prev, lo - prev))
            prev = max(prev, hi)
        if self.window_s > prev:
            edges.append((prev, self.window_s - prev))
        out = []
        for start, length in sorted(edges, key=lambda e: -e[1])[:n]:
            inside = np.nonzero((self.host_start <= start) & (self.host_end > start))[0]
            name = ("no host operation" if inside.size == 0 else
                    self.host_names[inside[np.argmax(self.host_start[inside])]])
            out.append([_short(name), length])
        return out


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."


def from_profiler(prof, window_s: float) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    try:
        events = prof.profiler.kineto_results.events()
        for e in events:
            row = (e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9)
            (device if e.device_type() == DeviceType.CUDA else host).append(row)
    except AttributeError:  # an older profiler: its parsed event list
        for e in prof.events():
            row = (e.name, e.time_range.start * 1e-6, (e.time_range.end - e.time_range.start) * 1e-6)
            (device if e.device_type == DeviceType.CUDA else host).append(row)
    origin = min([s for _, s, _ in device] + [s for _, s, _ in host] or [0.0])
    device = [(n, s - origin, d) for n, s, d in device]
    start = np.array([s - origin for _, s, _ in host])
    return Trace(window_s=window_s, device=device, host_names=[n for n, _, _ in host],
                 host_start=start, host_end=start + np.array([d for _, _, d in host]))
