"""device.idle_pct: the share of one traced step's wall time in which the
card ran nothing: 1 - the union of its activity's intervals over the
window, in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
