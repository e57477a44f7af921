"""stage.dba_ms: milliseconds of the dba stage in one step run stage by
stage under the benchmark's synchronised spans (left out where the staged
answers differ from the step's)."""


def read(ctx):
    return None if ctx.spans is None or "dba" not in ctx.spans else ctx.spans["dba"] * 1e3
