"""span.tail_ms: milliseconds the card's stream took over the tail
(``multi_scenario_tail`` / ``gridded_tail``) in one step run with the port's
tracer on: the ``tail`` spans' CUDA-event times, summed over the step's
collections (``portbench/program_spans.py``). Nothing to read where the
program has no tracer or the traced step's answers differ from the untraced
step's."""

from portbench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx, "tail")
