"""Share of the encoder's rows whose GRU K4, the hand-written encoder
recurrence (csrc/encoder_gru.cu), computed: the program's
encoder_kernel_rows over its encoder_rows counters on the forward/encoder
spans, in the profiled batches. None where no span counts
encoder_kernel_rows (a program without the kernel)."""

from bench_port.harness import program as G


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    encoder = G.spans(recs, "forward/encoder")
    rows = G.total(encoder, "encoder_rows")
    if not rows or not any("encoder_kernel_rows" in r.counts
                           for r in encoder):
        return None
    return 100.0 * G.total(encoder, "encoder_kernel_rows") / rows
