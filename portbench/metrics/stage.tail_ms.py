"""stage.tail_ms: milliseconds of the tail stage in one step run stage by
stage under the benchmark's synchronised spans (left out where the staged
answers differ from the step's)."""


def read(ctx):
    return None if ctx.spans is None or "tail" not in ctx.spans else ctx.spans["tail"] * 1e3
