"""step_mfu: the operations one step needs (portbench/work.py: the entry's
own count, or the exact GP's counted from the cell's shapes and fit
profile) over the untraced step time and the card's peak in the
configuration's dtype (``work.peak_flops``), in percent."""

from portbench import work


def read(ctx):
    config = ctx.cell.config
    return 100.0 * work.step_ops(config, ctx.cell.profile) / (ctx.step_s * work.peak_flops(config))
