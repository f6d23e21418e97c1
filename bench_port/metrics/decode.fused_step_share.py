"""Share of the note decoders' steps that ran K2, the hand-written step
kernel (csrc/note_step.cu), read from the device trace: K2's attention
kernels (one a step) launched inside the program's decode/notes spans
(``Trace.launched_in``: a replay's kernels at its graph launch), over those
spans' note_steps counters, in the profiled batches. None where none ran
there (a program without the kernel, or steps that took the torch ops)."""

from bench_port.harness import program as G

# The demangled name of K2's attention kernel, one launch a step.
STEP_KERNEL = "attn_kernel(NoteStepArgs"


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    notes = G.spans(recs, "decode/notes")
    steps = G.total(notes, "note_steps")
    ivs = [(r.start_ns, r.end_ns) for r in notes]
    n = sum(STEP_KERNEL in name
            for _, _, name, _ in run.trace.launched_in(ivs))
    return 100.0 * n / steps if steps and n else None
