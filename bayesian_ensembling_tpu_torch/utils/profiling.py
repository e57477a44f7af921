"""Tracing and profiling seams.

Counterpart of ``bayesian_ensembling_tpu/utils/profiling.py``:

  * :func:`trace` wraps ``torch.profiler`` so any pipeline stage can dump a
    Chrome / TensorBoard-compatible trace of the host and, when there is a
    card, the device;
  * :class:`StepTimer` gives wall-clock stage timings ended by a device
    synchronisation (CUDA work is asynchronous, so a stage's wall time
    without one measures only its launches);
  * :func:`report_loss_trace` logs a loss trace after the fact.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
import typing as tp

import numpy as np
import torch

__all__ = ["trace", "StepTimer", "device_sync", "report_loss_trace"]


def _leaves(tree: tp.Any) -> tp.Iterator[tp.Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def device_sync(tree: tp.Any) -> None:
    """Wait for the work on every CUDA device that holds a tensor of
    ``tree`` (nested dicts, lists and tuples of tensors)."""
    devices = {leaf.device for leaf in _leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


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


class StepTimer:
    """Named wall-clock stage timings with device sync."""

    def __init__(self) -> None:
        self.timings: tp.Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync: tp.Any = None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            device_sync(sync)
        self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.3f}s" for k, v in self.timings.items())


def report_loss_trace(
    losses,
    every: int = 25,
    printer: tp.Callable[[str], None] = print,
    label: str = "loss",
) -> None:
    """Post-hoc loss logging: the mean over the leading axes every ``every``
    steps."""
    if isinstance(losses, torch.Tensor):
        losses = losses.detach().cpu().numpy()
    arr = np.asarray(losses)
    if arr.ndim == 1:
        arr = arr[None]
    for step in range(0, arr.shape[-1], every):
        printer(f"step {step}: {label} = {arr[..., step].mean():.4f}")
