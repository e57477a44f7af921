"""fit.launches_per_iter: launch calls on the host (kernel launches and
CUDA-graph replays, each call once) that start inside the ``bet.fit.loop``
ranges of one step profiled with the port's tracer on, over the optimiser
steps the port counted in it (``fit_step_counts``, summed;
``portbench/program_spans.py``)."""

from portbench import program_spans


def read(ctx):
    return program_spans.launches_per_iter(ctx)
