"""setup_s: seconds from the process's start to the window's (import,
the kernels' library, inputs, GRMs, any set-up REML, one warm unit)."""


def read(ctx):
    return ctx.setup_s
