"""Set-up: from the start of the process to the window's first request or
step: imports, the build and bind of the kernels, the weights, the warm-up
(and in training the checked steps)."""


def read(ctx):
    return ctx.setup_s
