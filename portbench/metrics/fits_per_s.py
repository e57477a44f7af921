"""fits_per_s: GP fits completed a second, every (model, problem) fit of
every step the window completed over the window's time: the step's batch
sizes (portbench/work.py) over step_s."""

from portbench import work


def read(ctx):
    return sum(b for b, _, _ in work.collections(ctx.cell.config)) / ctx.step_s
