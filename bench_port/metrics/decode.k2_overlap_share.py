"""Share of the boundaries between consecutive kernels of K2, the
hand-written greedy note step (csrc/note_step.cu), at which the second
kernel started on the card before the first ended: how often K2's
programmatic dependent launch takes effect. Of K2's kernels in the
profiled stretch (by the fragment of their demangled names), in order of
device start, each pair less than GAP_NS apart counts (a replay's
kernels; not the host's stop read between replays), and overlaps where
the second starts before the first ends. None where no such pair ran (a
program without the kernel)."""

# In the demangled name of each of K2's kernels (attn, gru, proj, final).
KERNELS = "NoteStepArgs"
GAP_NS = 20_000


def read(run):
    t = run.trace
    if t is None:
        return None
    pairs = early = 0
    end = None
    for s, e, name, _ in t.device:
        if KERNELS not in name or not t.t0 <= s < t.t1:
            continue
        if end is not None and s - end < GAP_NS:
            pairs += 1
            early += s < end
        end = e
    return 100.0 * early / pairs if pairs else None
