"""chol_solve_roofline: the least time of one step's launches of the chol_solve
kernel at the cell's shapes (portbench/work.py) over the device time the
profiler gave the kernels whose name holds PATTERN in one traced step, in
percent.  Nothing to read where the step launched none."""

from portbench import work

PATTERN = "chol_solve_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    least = work.kernel_step_seconds("chol_solve", ctx.cell.config, ctx.cell.profile)
    seconds = ctx.trace.seconds_of(PATTERN)
    if least is None or seconds <= 0.0:
        return None
    return 100.0 * least / seconds
