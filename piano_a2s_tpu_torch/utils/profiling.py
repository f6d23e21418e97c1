"""Profiling hooks of the training harness (``--profile``): a
``torch.profiler`` trace of a region, written as a Chrome trace, and a
per-step wall-clock timer that synchronizes with the CUDA device. The
counterpart of piano_a2s_tpu/utils/profiling.py; named sub-regions are
``torch.profiler.record_function`` (train/step.py marks its stages)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed region with ``torch.profiler`` (host ops, and the
    CUDA kernels when a card is present) and write it to
    <log_dir>/trace.json, viewable in chrome://tracing or Perfetto."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
