"""The run's environment and its result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (name -> {"value", "unit"}),
``device`` and, in a traced run, ``breakdown``; then ``checks``, each
compared number with its limit. The same checks are the last lines of
standard error.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

# Whole top-level names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "piano_a2s_tpu")
PROGRAM = "piano_a2s_tpu_torch"


class RunError(RuntimeError):
    """A run that cannot produce a result: the process exits non-zero."""


def prepare_environment(root: str) -> None:
    """The program's build and kernel caches at fixed places in the checkout, and
    no library that would load JAX by itself."""
    cache = os.path.join(root, "build", "bench_port")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_program(root: str) -> None:
    """The program must be the checkout's own package."""
    import importlib.util

    found = importlib.util.find_spec(PROGRAM)
    if found is None or not found.origin:
        raise RunError(f"{PROGRAM} is not in this checkout")
    where = os.path.realpath(os.path.dirname(found.origin))
    if not where.startswith(os.path.realpath(root) + os.sep):
        raise RunError(f"{PROGRAM} comes from {where}, not from the "
                       f"checkout at {root}")


def require_devices(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise RunError(f"{torch.cuda.device_count()} CUDA devices, the cell "
                       f"asks for {chips}")


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def device_info(chips: int, peak_bytes: int, trace=None) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
         device: dict, checks: Dict[str, dict],
         breakdown: Optional[dict] = None) -> None:
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
