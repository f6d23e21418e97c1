"""Share of the rows the note decoders' steps computed that belonged to a
(staff, stop group) still decoding: the program's rows_active over its
rows_computed counters (both staves are always stepped), in the profiled
batches."""

from bench_port.harness import program as G


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    computed = G.total(recs, "rows_computed")
    return 100.0 * G.total(recs, "rows_active") / computed if computed \
        else None
