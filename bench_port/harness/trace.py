"""A profiled stretch of a run and what the per-layer metrics read from it.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (host and device
activity) inside a ``bench/stretch`` span, and reads the raw events
without building the profiler's event tree (a decoded batch is some
hundred thousand launches):

- device activity: kernels, copies and sets, each placed at the host
  time of its own launch: the CUDA API call whose correlation id
  it carries (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
  ``cudaMemcpyAsync``, ``cudaMemsetAsync``; for every kernel of a replayed
  CUDA graph, the ``cudaGraphLaunch``). An activity whose launch the trace
  lacks is placed at its device start, and counted in ``unplaced``;
- host spans: the ``record_function`` ranges (the program's own, such as
  ``train_step/backward``, and those the benchmark puts around a layer's
  call, such as ``forward/decoder``);
- the host's outermost operator at each moment, to say what the host did
  while the device sat idle.

Spans are read only from this process's main thread.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

STRETCH = "bench/stretch"
_DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_ACTIVITY = ("cuda_runtime", "cuda_driver")


def kind(e) -> str:
    """The event's kineto activity type, worked out from its device and
    name where the event does not give it (older torch)."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if "/" in name and not name.startswith(("void ", "Memcpy", "Memset")):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return "user_annotation"
    if name.startswith(("cuda", "cu")) and "::" not in name:
        return "cuda_runtime"
    if "/" in name and "::" not in name:
        return "user_annotation"
    return "cpu_op"


class Trace:
    def __init__(self, events, main_tid: Optional[int] = None):
        # start, end, name, host time of the launch (else the start)
        self.device: List[Tuple[int, int, str, int]] = []
        self.spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.launch: Dict[int, int] = {}    # correlation id -> host start
        device = []
        ops: List[Tuple[int, int, str]] = []
        for e in events:
            act = kind(e)
            if act in _DEVICE_ACTIVITY:
                device.append((e.start_ns(), e.end_ns(), e.name(),
                               e.correlation_id()))
            elif act in _LAUNCH_ACTIVITY:
                self.launch[e.correlation_id()] = e.start_ns()
            elif act == "user_annotation":
                if main_tid is None or e.start_thread_id() == main_tid:
                    self.spans[e.name()].append((e.start_ns(), e.end_ns()))
            elif act == "cpu_op":
                if main_tid is None or e.start_thread_id() == main_tid:
                    ops.append((e.start_ns(), e.end_ns(), e.name()))
        self.unplaced = 0     # activities placed at their device start
        for s, e, name, corr in device:
            at = self.launch.get(corr)
            self.unplaced += at is None
            self.device.append((s, e, name, s if at is None else at))
        self.device.sort()
        for v in self.spans.values():
            v.sort()
        stretch = self.spans.get(STRETCH) or [
            (min(d[0] for d in self.device), max(d[1] for d in self.device))]
        self.t0, self.t1 = stretch[0][0], stretch[-1][1]
        self.top_ops = _outermost(ops)

    # -- the device ------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def _merged(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for s, e, _, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged()) * 1e-9

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for s, e, n, _ in self.device if match(n)) * 1e-9

    def launched_in(self, intervals) -> List[Tuple[int, int, str, int]]:
        """The device activities launched inside any of the host
        ``intervals`` ((start, end) pairs, which may overlap or nest)."""
        merged: List[List[int]] = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts = [m[0] for m in merged]
        out = []
        for d in self.device:
            i = bisect.bisect_right(starts, d[3]) - 1
            if i >= 0 and d[3] < merged[i][1]:
                out.append(d)
        return out

    def span_device_seconds(self, names) -> float:
        """Device time of the work launched inside spans of ``names``."""
        ivs = [iv for n in names for iv in self.spans.get(n, ())]
        return sum(e - s for s, e, _, _ in self.launched_in(ivs)) * 1e-9

    def span_seconds(self, name: str) -> List[float]:
        return [(e - s) * 1e-9 for s, e in self.spans.get(name, ())]

    # -- the breakdown ---------------------------------------------------

    def top_kernels(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.device:
            by[name] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v * 1e-9] for k, v in top]

    def idle_by_host(self, n: int = 10) -> List[list]:
        """Idle device time inside the stretch, summed by what the host was
        doing at each gap's middle: the innermost span and the outermost
        operator there (or "python" between operators)."""
        gaps = []
        prev = self.t0
        for s, e in self._merged():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        span_ivs = sorted((s, e, name) for name, ivs in self.spans.items()
                          if name != STRETCH for s, e in ivs)
        op_starts = [o[0] for o in self.top_ops]
        by: Dict[str, int] = defaultdict(int)
        for a, b in gaps:
            mid = (a + b) // 2
            span = "no span"
            for s, e, name in span_ivs:  # few spans: innermost = last start
                if s > mid:
                    break
                if mid < e:
                    span = name
            i = bisect.bisect_right(op_starts, mid) - 1
            op = (self.top_ops[i][2]
                  if i >= 0 and mid < self.top_ops[i][1] else "python")
            by[f"{span} | {op}"] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]


def _outermost(ops: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    ops.sort(key=lambda o: (o[0], -o[1]))
    out: List[Tuple[int, int, str]] = []
    end = -1
    for s, e, name in ops:
        if s >= end:
            out.append((s, e, name))
            end = e
    return out


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def profiled(fn: Callable):
    """(fn's result, Trace, host seconds) of fn run under the profiler,
    inside a ``bench/stretch`` span; the device is synchronised before the
    stretch closes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            t0 = time.perf_counter()
            try:
                result = fn()
            finally:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    # Kineto's thread ids are its own: take the one that opened the span.
    tid = next((e.start_thread_id() for e in events if e.name() == STRETCH),
               None)
    return result, Trace(events, tid), wall
