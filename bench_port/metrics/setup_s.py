"""Set-up seconds: program import, weights, build, the warm-up call(s)."""


def read(run):
    return run.setup_s
