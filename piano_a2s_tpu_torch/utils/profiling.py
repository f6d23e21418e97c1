"""Profiling of the port: one recorder of spans and counters, and the
training harness's hooks (``--profile``). The counterpart of
piano_a2s_tpu/utils/profiling.py.

Tracing is on exactly while a ``torch.profiler`` records in the calling
thread (``active()``; the autograd engine's threads inherit it during a
backward): nothing else turns it on. Then ``span(name)`` keeps a ``Span``
in memory: its name, start and end in the profiler's host clock
(``time.time_ns()``, the clock of the kineto events' ``start_ns()``), its
thread and its parent span on that thread; it also opens a
``record_function`` range of that name, so the span is in the kineto
trace, unless ``ranged=False``. A range is a host op of its own, and
kineto links each kernel to the id of the host op that launched it, so
every range shifts the ids of the ops after it; the serving path's spans
(the Transcriber's, the greedy forward's, the note decoders') keep none,
so that a traced batch runs its operators' host ops only, and a reader
that goes by those ids (bench_port/harness/trace.py) places the same
kernels with the spans or without them.
``count(name, n)`` adds ``n`` to the innermost open span of the calling
thread, or keeps a timestamped ``Count`` where none is open, so every
count can be windowed by time; ``records(t0_ns, t1_ns)`` returns those of
a window. With tracing off both cost one check a call and record
nothing; per-step quantities are counters, spans go at most per bar.

What reads them: the benchmark's per-layer metrics (bench_port/metrics)
and PERF.md's layer table, which names each span and counter.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Union

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
CAPACITY = 1 << 20              # records; a profiled stretch holds far fewer

_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


def active() -> bool:
    """Whether a ``torch.profiler`` records in this thread."""
    return _enabled()


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    start_ns: int
    end_ns: Optional[int]           # None while the span is open
    thread: int
    parent: Optional["Span"]
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(eq=False)
class Count:
    """A count made where no span was open on the counting thread."""
    name: str
    at_ns: int
    n: int
    thread: int


class _Open:
    """One ``span`` call's region: the record (tracing on) and the wall
    added to ``into[key]`` (when given)."""

    __slots__ = ("rec", "name", "on", "ranged", "into", "key", "_rf",
                 "_span", "_t0")

    def __init__(self, rec, name, on, ranged, into, key):
        self.rec, self.name, self.on, self.ranged = rec, name, on, ranged
        self.into, self.key = into, key

    def __enter__(self):
        if self.on:
            if self.ranged:
                self._rf = record_function(self.name)
                self._rf.__enter__()
            self._span = self.rec._open_span(self.name)
        if self.into is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            self.into[self.key] = (self.into.get(self.key, 0.0)
                                   + time.perf_counter() - self._t0)
        if self.on:
            self.rec._close_span(self._span)
            if self.ranged:
                self._rf.__exit__(*exc)
        return False


class Recorder:
    """The process's spans and counts, kept while tracing is on (the
    profiler, too, is one per process). Holds up to ``capacity`` records;
    past that it drops them and remembers when it began to, so that a
    window it cut short reads as None (``records``)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._buf: List[Union[Span, Count]] = []
        self._lost_at: Optional[int] = None
        self._local = threading.local()

    def clear(self) -> None:
        self._buf, self._lost_at = [], None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, rec, at: int) -> None:
        if len(self._buf) < self.capacity:
            self._buf.append(rec)
        elif self._lost_at is None:
            self._lost_at = at

    def _open_span(self, name: str) -> Span:
        stack = self._stack()
        rec = Span(name, time.time_ns(), None, threading.get_ident(),
                   stack[-1] if stack else None)
        stack.append(rec)
        self._keep(rec, rec.start_ns)
        return rec

    def _close_span(self, rec: Span) -> None:
        rec.end_ns = time.time_ns()
        stack = self._stack()
        if stack and stack[-1] is rec:
            stack.pop()

    def span(self, name: str, into: Optional[dict] = None,
             key: Optional[str] = None, ranged: bool = True):
        """A region named ``name`` (see the module docstring). ``into``
        (a dict) takes the region's wall seconds under ``key`` whether
        tracing is on or not; ``ranged=False`` keeps the region out of the
        kineto trace (a record only)."""
        on = _enabled()
        if not on and into is None:
            return _NULL
        return _Open(self, name, on, ranged, into, key)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` (see the module docstring)."""
        if not _enabled():
            return
        stack = self._stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n
        else:
            at = time.time_ns()
            self._keep(Count(name, at, n, threading.get_ident()), at)

    def records(self, t0_ns: int, t1_ns: int
                ) -> Optional[List[Union[Span, Count]]]:
        """The closed spans and the counts that lie inside [t0_ns, t1_ns]
        (the profiler's host clock), in the order they began; None when
        the buffer dropped records before ``t1_ns`` (the window's would be
        cut short)."""
        if self._lost_at is not None and self._lost_at <= t1_ns:
            return None
        out = []
        for r in list(self._buf):
            if isinstance(r, Span):
                if (r.end_ns is not None and t0_ns <= r.start_ns
                        and r.end_ns <= t1_ns):
                    out.append(r)
            elif t0_ns <= r.at_ns <= t1_ns:
                out.append(r)
        return out


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
records = RECORDER.records


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed region with ``torch.profiler`` (host ops, and the
    CUDA kernels when a card is present) and write it to
    <log_dir>/trace.json, viewable in chrome://tracing or Perfetto. The
    recorder's records are cleared on exit."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    try:
        with profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    finally:
        RECORDER.clear()


class StepTimer:
    """Wall-clock per-step timing with an explicit device sync: a region
    timed with ``time(name)`` ends when the CUDA work it queued has
    finished, found from the tensors put in the yielded container (or
    ``result_tree``). Tensors on the CPU need no sync."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = {}

    @staticmethod
    def sync(values) -> None:
        devices = {v.device for v in values
                   if isinstance(v, torch.Tensor) and v.is_cuda}
        for dev in devices:
            torch.cuda.synchronize(dev)

    @contextlib.contextmanager
    def time(self, name: str, result_tree=None):
        t0 = time.perf_counter()
        container = {}
        yield container
        if result_tree is not None:
            self.sync(result_tree)
        elif container:
            self.sync(list(container.values()))
        self.durations.setdefault(name, []).append(
            time.perf_counter() - t0)

    def summary(self, since: Optional[Dict[str, int]] = None
                ) -> Dict[str, Dict[str, float]]:
        """Stats over all recorded durations, or, with ``since`` (a mark
        from .mark()), only over those recorded after the mark (one
        epoch's steps)."""
        out = {}
        for name, vals in self.durations.items():
            if since is not None:
                vals = vals[since.get(name, 0):]
            if not vals:
                continue
            n = len(vals)
            out[name] = {
                "count": n,
                "mean_s": sum(vals) / n,
                "min_s": min(vals),
                "max_s": max(vals),
                "total_s": sum(vals),
            }
        return out

    def mark(self) -> Dict[str, int]:
        """Position marker for summary(since=...)."""
        return {name: len(vals) for name, vals in self.durations.items()}
