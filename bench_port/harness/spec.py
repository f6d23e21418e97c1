"""Finds the benchmark's pieces by the names in BENCHMARK.json.

- ``configs/<config>.json``: a configuration's sizes, precision and peaks;
- ``traffic/<traffic>.json``: a traffic mix's parameters and the entry
  (``entries/<entry>.py``) that offers it to the program;
- ``workloads/<cell>.json``: what belongs to one cell alone (the limits of
  its correctness check, with the readings they were set from);
- ``metrics/<metric>.py``: the reader of one per-layer metric.

Adding a configuration, a mix or a metric adds files and entries; nothing
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Callable, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its "workloads" list,
    else (a per-layer metric) every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files loaded."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=entry["chips"],
                config=_json("configs", f"{entry['config']}.json"),
                traffic=_json("traffic", f"{entry['traffic']}.json"),
                limits=_json("workloads", f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=per_layer)


def entry(name: str):
    """The module ``entries/<name>.py``."""
    return importlib.import_module(f"bench_port.entries.{name}")


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py`` (the name may hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def data_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "data", name)
