"""The program's own spans and counters (``piano_a2s_tpu_torch.utils
.profiling``: ``records``), windowed to a run's profiled stretch, and the
device work that runs inside those spans.

A program that keeps no records (one from before the recorder) reads
None, and so does a window the recorder cut short: a metric that reads
them then leaves the result line rather than print a partial number.
"""

from __future__ import annotations

import bisect
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
    """(count, device seconds) of the kernels, copies and sets that start
    on the card inside the program's ``spans`` (records, which must not
    nest: ``decode/notes``, which keeps no kineto range).

    An activity is placed by its device start, not by ``trace.launch``,
    which finds a launch by the activity's linked correlation id: that is
    the id of a host op, not of the launch, and misplaces launches between
    neighbouring spans (15159-30093 a bar where each bar launches 17526,
    H100, torch 2.11). Work launched in a ``decode/notes`` span starts
    inside it while the card keeps pace with the host, as the loop waits
    on the device at every stop read; work queued before the span opens,
    or left running when it closes, lands wrong (a cold card: 45.09
    launches a step against 44.0352).
    """
    ivs = sorted((r.start_ns, r.end_ns) for r in spans)
    starts = [s for s, _ in ivs]
    n = t = 0
    for s, e, _, _ in trace.device:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < ivs[i][1]:
            n += 1
            t += e - s
    return n, t * 1e-9
