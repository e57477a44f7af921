"""stage.posterior_ms: milliseconds of the posterior stage in one step run stage by
stage under the benchmark's synchronised spans (left out where the staged
answers differ from the step's)."""


def read(ctx):
    return None if ctx.spans is None or "posterior" not in ctx.spans else ctx.spans["posterior"] * 1e3
