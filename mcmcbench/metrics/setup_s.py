"""Set-up: process start to the first timed step (imports, the kernels built
or loaded, inputs drawn, warm-up and burn-in), on the host clock."""


def read(run):
    return run.setup_s
