"""Clips the window's batches completed over the window's seconds."""


def read(run):
    return sum(u["clips"] for u in run.units) / run.window_s
