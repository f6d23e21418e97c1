"""Clips of the window's completed training steps over the window's
seconds (the last step synchronised)."""


def read(run):
    return sum(u["clips"] for u in run.units) / run.window_s
