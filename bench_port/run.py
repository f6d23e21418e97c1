#!/usr/bin/env python3
"""Run one cell of the benchmark of piano_a2s_tpu_torch once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of BENCHMARK.json's "workloads") names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``,
whose "entry" is ``entries/<entry>.py``). The entry makes the weights
and the inputs from the seed, sets up the program and warms it, measures
for ``--seconds``, and judges what the window produced against the plain
reference (``harness/reference.py``). With ``--trace 0`` the result line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (``metrics/<name>.py``) from a profiled stretch of the window.

Exits non-zero, printing no result, without a CUDA device (or fewer than
the cell asks for), without the program in this checkout, or when JAX or
the JAX package got loaded.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    from bench_port.harness import contract, spec
    from bench_port.harness.record import Run

    contract.prepare_environment(ROOT)
    try:
        contract.require_program(ROOT)
        cell = spec.cell(args.workload)
        contract.require_devices(cell.chips)
    except (contract.RunError, KeyError, OSError) as exc:
        print(f"bench_port: {exc}", file=sys.stderr)
        return 2

    run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              traced=bool(args.trace))
    spec.entry(cell.traffic["entry"]).run(run)

    found = contract.forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3

    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    if run.trace is not None:
        breakdown = {"device_ops": run.trace.top_kernels(),
                     "idle_gaps": run.trace.idle_by_host()}
        print(f"bench_port: {run.trace.unplaced} device activities without "
              f"their launch in the trace, placed at their device start",
              file=sys.stderr)
    seconds = [u["t1"] - u["t0"] for u in run.timed_units()]
    if seconds:
        print(f"bench_port: {len(seconds)} timed units, ms each: "
              f"{[round(1e3 * t) for t in seconds]}", file=sys.stderr)
    contract.emit(run.correct, run.attempted, run.failed, metrics,
                  contract.device_info(cell.chips, run.peak_bytes, run.trace),
                  run.checks, breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
