"""step_mfu: the operations one step needs (portbench/work.py, counted from
the cell's shapes and fit profile) over the untraced step time and the
card's float32 peak, in percent."""

from portbench import work


def read(ctx):
    return 100.0 * work.step_ops(ctx.cell.config, ctx.cell.profile) / (ctx.step_s * work.FP32_FLOPS)
