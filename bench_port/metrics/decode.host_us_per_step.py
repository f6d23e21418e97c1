"""Host microseconds per note decoder step outside the stop read: the
walls of the program's decode/notes spans less their stop_read_ns
counters, over their note_steps, in the profiled batches (under the
profiler, which slows the host)."""

from bench_port.harness import program as G


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    notes = G.spans(recs, "decode/notes")
    steps = G.total(notes, "note_steps")
    if not steps:
        return None
    host_s = G.wall_s(notes) - 1e-9 * G.total(notes, "stop_read_ns")
    return 1e6 * host_s / steps
