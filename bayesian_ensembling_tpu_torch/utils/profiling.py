"""Tracing and profiling seams.

  * :func:`span` marks one layer of the program where its work is issued:
    a step, the DBA targets, a fit and its optimiser loop, the posterior,
    the tail.  Off by default, it costs one read of a module flag and
    returns a shared no-op context.
  * :func:`recording` turns the spans on for a block.  Each span then
    records its name, id, parent, root (the outermost span open on its
    thread: the step) and attributes, its host interval, and, on a CUDA
    tensor, two timing events on the current stream (no synchronisation);
    it also enters ``torch.profiler.record_function("bet." + name)``, so
    under a profiler the span is a range of the trace on the profiler's own
    clock.  The spans are kept in memory and resolved, with one
    synchronisation, when the block ends.
  * :func:`trace` wraps ``torch.profiler`` so any pipeline stage can dump a
    Chrome / TensorBoard-compatible trace of the host and, when there is a
    card, the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import tempfile
import threading
import time
import typing as tp

import torch

__all__ = ["SpanRecord", "Recording", "span", "recording", "trace"]

# The one module flag a span reads: the Recording of the open recording()
# block, None outside one.
_active: tp.Optional["Recording"] = None
_NULL = contextlib.nullcontext()
_local = threading.local()


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span.  ``device_ms`` is the time between its two CUDA
    events on the stream it was issued to (None for work on the CPU)."""

    name: str
    id: int
    parent: tp.Optional[int]
    root: int
    attrs: tp.Dict[str, tp.Any]
    host_start_ns: int
    host_end_ns: int
    device_ms: tp.Optional[float]

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6


class Recording:
    """The spans of one :func:`recording` block: ``spans``, in the order
    they began, is filled when the block ends."""

    def __init__(self) -> None:
        self.spans: tp.List[SpanRecord] = []
        self._ids = itertools.count(1)
        self._done: tp.List["_Span"] = []

    def _resolve(self) -> None:
        for device in {s.device for s in self._done if s.device is not None}:
            torch.cuda.synchronize(device)
        self.spans = sorted((s.record() for s in self._done), key=lambda r: r.id)
        self._done = []


def _stack() -> tp.List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("rec", "name", "attrs", "device", "id", "parent", "root", "t0", "t1", "events",
                 "range")

    def __init__(self, rec: Recording, name: str, like: tp.Optional[torch.Tensor], attrs):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.device = None
        if like is not None:
            attrs["dtype"] = str(like.dtype).replace("torch.", "")
            if like.is_cuda:
                self.device = like.device

    def __enter__(self) -> "_Span":
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.range = torch.profiler.record_function(
            "bet." + self.name, " ".join(f"{k}={v}" for k, v in self.attrs.items()))
        self.range.__enter__()
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self.device is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.range.__exit__(*exc)
        _stack().pop()
        self.rec._done.append(self)
        return False

    def record(self) -> SpanRecord:
        device_ms = (self.events[0].elapsed_time(self.events[1]) if self.device is not None
                     else None)
        return SpanRecord(self.name, self.id, self.parent, self.root, self.attrs, self.t0,
                          self.t1, device_ms)


def span(name: str, like: tp.Optional[torch.Tensor] = None, **attrs):
    """A context that marks the block as the program's layer ``name``.

    ``like`` is a tensor of the layer's work: its dtype is recorded, and
    when it is on a card the span is timed on that card's current stream.
    ``attrs`` (the batch ``B``, the length ``T``, ...) are recorded with
    the span and shown with its profiler range.  Outside :func:`recording`
    this returns one shared no-op context."""
    rec = _active
    if rec is None:
        return _NULL
    return _Span(rec, name, like, attrs)


@contextlib.contextmanager
def recording():
    """Record every span of the block; yields a :class:`Recording` whose
    ``spans`` are filled when the block ends (after one synchronisation of
    each card the spans were timed on).  Blocks do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("recording() blocks do not nest")
    rec = _active = Recording()
    try:
        yield rec
    finally:
        _active = None
        rec._resolve()


@contextlib.contextmanager
def trace(log_dir: tp.Optional[str] = None):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when it
    is available) and write a Chrome trace, ``trace.json``, into ``log_dir``
    (``bet_trace`` under the temporary directory by default).  Yields the
    profiler, whose ``key_averages()`` summarise the block."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "bet_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
