"""Seconds from the process's start to the window's first batch: imports,
the kernels' build (only the first run in a checkout), inputs, weights and
the warm call."""


def read(run):
    return run.setup_s
