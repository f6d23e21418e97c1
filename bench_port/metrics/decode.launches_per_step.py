"""Device activities (kernels, copies, sets) that run inside the
program's decode/notes spans (one a bar: the note decoders' loop) per
step those spans ran (their note_steps counters), in the profiled
batches."""

from bench_port.harness import program as G


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    notes = G.spans(recs, "decode/notes")
    steps = G.total(notes, "note_steps")
    n, _ = G.launched(run.trace, notes)
    return n / steps if steps and n else None
