"""setup_s: seconds from the process's start to the first timed case:
importing torch and the program, the CUDA context, loading the built
kernels (building them in a checkout's first run), generating the
cases, and one warm-up unit of the cell's own shape."""


def read(ctx):
    return ctx.setup_s
