"""What an entry hands back: the run's timings, units of work, trace and
checks, which the metric readers (``metrics/<name>.py``) read."""

from __future__ import annotations

import dataclasses
import math
import time
from collections import defaultdict
from typing import Any, Dict, List

from .spec import Cell


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: str = "cuda"
    setup_s: float = 0.0
    window_s: float = 0.0
    units: List[dict] = dataclasses.field(default_factory=list)
    trace: Any = None
    peak_bytes: int = 0
    window_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def check(self, name: str, value, limit, upper: bool = True) -> None:
        """Record a compared number: it must be at most ``limit`` (upper)
        or at least it."""
        ok = value <= limit if upper else value >= limit
        if isinstance(value, float) and not math.isfinite(value):
            value = 1e300 if value > 0 or math.isnan(value) else -1e300
            ok = False
        self.checks[name] = {"value": value, "limit": limit, "ok": bool(ok)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["ok"] for c in self.checks.values())

    def timed_units(self) -> List[dict]:
        """The window's units that ran outside the profiled stretch."""
        return [u for u in self.units if not u.get("profiled")]


class LayerSpans:
    """A ``record_function`` range and a host clock around every call of
    the wrapped modules: the benchmark's own spans at the program's layer
    boundaries."""

    def __init__(self):
        self.wall: Dict[str, float] = defaultdict(float)

    def wrap(self, module, name: str, on_output=None) -> None:
        """Wrap ``module.forward``; ``on_output`` is handed each call's
        result (a reference to what the program returned)."""
        from torch.profiler import record_function

        inner = module.forward

        def forward(*args, **kwargs):
            t0 = time.perf_counter()
            with record_function(name):
                out = inner(*args, **kwargs)
            self.wall[name] += time.perf_counter() - t0
            if on_output is not None:
                on_output(out)
            return out

        module.forward = forward

    def snapshot(self) -> Dict[str, float]:
        return dict(self.wall)
