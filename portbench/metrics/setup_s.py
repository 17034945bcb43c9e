"""Set-up seconds: from the start of the run's process to the start of the
measured window (imports, CUDA start-up, building or loading the kernels,
making the inputs, the warm-up), on the host's clock."""


def read(ctx):
    return ctx.setup_s
