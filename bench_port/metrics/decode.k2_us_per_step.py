"""Device microseconds a greedy note step of K2, the hand-written step
kernel (csrc/note_step.cu), takes on the card from its first kernel's start
to its last kernel's end: K2's kernels, found by the fragment of their
demangled names, their device intervals merged wherever one starts less
than GAP_NS after the last ended (so that a replay of a graph of steps is
one interval, gaps and overlaps between its kernels included, and the
host's stop read between replays is not), summed over the profiled
stretch and divided by the note_steps of the program's decode/notes
records. None where no K2 kernel ran (a program without the kernel) or
the program kept no records."""

from bench_port.harness import program as G

# In the demangled name of each of K2's kernels (attn, gru, proj, final).
KERNELS = "NoteStepArgs"
GAP_NS = 20_000


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    steps = G.total(G.spans(recs, "decode/notes"), "note_steps")
    t = run.trace
    busy = 0
    last = None  # the merged interval open, [start, end]
    for s, e, name, _ in t.device:
        if KERNELS not in name or not t.t0 <= s < t.t1:
            continue
        if last is not None and s - last[1] < GAP_NS:
            last[1] = max(last[1], e)
            continue
        if last is not None:
            busy += last[1] - last[0]
        last = [s, e]
    if last is None or not steps:
        return None
    busy += last[1] - last[0]
    return busy * 1e-3 / steps
