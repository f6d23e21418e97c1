"""Device microseconds a step of K4, the hand-written encoder recurrence
(csrc/encoder_gru.cu): the device time of its kernels, found by their
demangled name, over the steps the profiled encoder calls ran (the
program's forward/encoder spans x 2 layers x the cell's frames; both
directions of a layer run at once, in one launch). None where no K4 kernel
ran (a program without the kernel) or the program kept no records."""

from bench_port.harness import program as G

# The name of K4's kernel, one launch a layer.
KERNEL = "encoder_gru_kernel"
LAYERS = 2


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    calls = len(G.spans(recs, "forward/encoder"))
    t = run.trace.kernel_seconds(lambda name: KERNEL in name)
    if not calls or not t:
        return None
    return 1e6 * t / (calls * LAYERS * run.cell.config["frames"])
