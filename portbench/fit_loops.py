"""The port's optimiser loops of a traced step, for the readers that split the
fit's time by its loops' attributes (``fit.blocked_ms``,
``fit.fine_roofline``).

Step (a) of ``program_spans.py`` (the port's tracer on, no profiler) gives
each ``fit.loop`` span its CUDA-event time and the attributes it was opened
with: the batch ``B``, the length ``T`` and, where the program records it,
the linear-algebra ``route`` of its NLML (``kernel``, ``blocked`` or
``library``).
"""

from __future__ import annotations

import typing as tp


def loops(ctx) -> tp.Optional[list]:
    """The ``fit.loop`` spans of step (a) under its ``step`` root; None where
    there is no step root, no loop, or a loop ran on the CPU."""
    spans = ctx.program_spans
    if not spans:
        return None
    root = next((s.root for s in spans if s.name == "step"), None)
    found = [s for s in spans if s.name == "fit.loop" and s.root == root]
    if root is None or not found or any(s.device_ms is None for s in found):
        return None
    return found


def attrs(span) -> dict:
    return getattr(span, "attrs", None) or {}


def route_ms(ctx, route: str) -> tp.Optional[float]:
    """Device milliseconds of the loops whose ``route`` is ``route`` (0.0
    where the loops carry a route and none is that one); None where there
    are no loops or they carry no route."""
    found = loops(ctx)
    if found is None or any("route" not in attrs(s) for s in found):
        return None
    return float(sum(s.device_ms for s in found if attrs(s)["route"] == route))
