"""Share of the note decoders' steps that ran inside CUDA graph replays:
the program's graph_steps over its note_steps counters on the decode/notes
spans, in the profiled batches. None where no span counts graph_steps (a
program without the graph path, or one that ran none)."""

from bench_port.harness import program as G


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    notes = G.spans(recs, "decode/notes")
    steps = G.total(notes, "note_steps")
    if not steps or not any("graph_steps" in r.counts for r in notes):
        return None
    return 100.0 * G.total(notes, "graph_steps") / steps
