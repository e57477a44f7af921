"""setup_s: process start to the first timed step: imports, the CUDA
context, the kernels' library (built on a checkout's first run, loaded
after), the input pool and the warm-up step."""


def read(ctx):
    return ctx.setup_s
