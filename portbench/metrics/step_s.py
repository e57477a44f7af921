"""step_s: the wall time of one ensemble step (DBA, fit, posterior, tail,
answers on the host), the whole window over the steps it completed."""


def read(ctx):
    return ctx.step_s
