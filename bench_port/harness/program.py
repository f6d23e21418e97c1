"""The program's own spans and counters (``piano_a2s_tpu_torch.utils
.profiling``: ``records``), windowed to a run's profiled stretch, and the
device work launched inside those spans.

A program that keeps no records (one from before the recorder) reads
None, and so does a window the recorder cut short: a metric that reads
them then leaves the result line rather than print a partial number.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def records(run) -> Optional[list]:
    """The program's spans and counts inside ``run.trace``'s stretch (the
    profiler's host clock), or None."""
    if run.trace is None:
        return None
    try:
        from piano_a2s_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    return None if read is None else read(run.trace.t0, run.trace.t1)


def spans(recs: list, name: str) -> list:
    return [r for r in recs if hasattr(r, "counts") and r.name == name]


def total(recs: list, counter: str) -> int:
    """``counter`` summed over the spans' counts and the bare counts."""
    n = 0
    for r in recs:
        if hasattr(r, "counts"):
            n += r.counts.get(counter, 0)
        elif r.name == counter:
            n += r.n
    return n


def wall_s(recs: List) -> float:
    return sum(r.end_ns - r.start_ns for r in recs) * 1e-9


def launched(trace, spans: list) -> Tuple[int, float]:
    """(count, device seconds) of the kernels, copies and sets launched
    inside the program's ``spans`` (records), wherever they run on the
    card (``Trace.launched_in``)."""
    work = trace.launched_in([(r.start_ns, r.end_ns) for r in spans])
    return len(work), sum(e - s for s, e, _, _ in work) * 1e-9
