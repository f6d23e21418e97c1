"""The window's peak of allocated device memory
(torch.cuda.max_memory_allocated after a reset at the window's start)."""


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes else None
