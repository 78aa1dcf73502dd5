"""Set-up: process start to the first timed operation (loading, the
kernels' build or load, weights, warm-ups and captures)."""


def read(run):
    return run.setup_s
