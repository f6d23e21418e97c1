"""Share of the staff summaries' sequences that K3, the hand-written
staff-summary kernel, computed: the program's summary_kernel_rows over its
summary_rows counters on the forward/decoder spans, in the profiled
batches. None where no span counts summary_kernel_rows (a program without
the kernel)."""

from bench_port.harness import program as G


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    decoder = G.spans(recs, "forward/decoder")
    rows = G.total(decoder, "summary_rows")
    if not rows or not any("summary_kernel_rows" in r.counts
                           for r in decoder):
        return None
    return 100.0 * G.total(decoder, "summary_kernel_rows") / rows
