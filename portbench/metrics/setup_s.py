"""Set-up: process start to the window's start (imports, the kernels' build
and load, the target, the warm job)."""


def read(run):
    return run.setup_s
