"""fit.idle_pct: the share of the union of the ``bet.fit.loop`` ranges of
one step profiled with the port's tracer on in which the card ran nothing,
in percent (``portbench/program_spans.py``)."""

from portbench import program_spans


def read(ctx):
    return program_spans.idle_pct(ctx)
