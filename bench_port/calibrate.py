#!/usr/bin/env python3
"""Readings that the correctness limits are set from (not run by the
benchmark's own runs).

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 0.1] [--control] [--fault <name>]

For each seed: one short run of the cell's entry (the timed path at the
cell's sizes, then its check against the float64 reference), printing the
numbers compared; with --control also the control's: the reference in
TF32 put in the program's place, which the limits must reject; with
--fault the program runs with that fault planted (harness/faults.py). One
JSON line a seed; the summary last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.1)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None,
                    help="a fault of harness/faults.py planted in the "
                         "timed path")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from bench_port.harness import contract, spec
    from bench_port.harness.record import Run

    contract.prepare_environment(ROOT)
    contract.require_program(ROOT)
    cell = spec.cell(args.workload)
    contract.require_devices(cell.chips)
    drv = spec.entry(cell.traffic["entry"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(cell=cell, seed=seed, seconds=args.seconds, traced=False)
        if args.fault:
            from bench_port.harness.faults import planted
            with planted(args.fault):
                drv.run(run)
        else:
            drv.run(run)
        row = {"seed": seed, "correct": run.correct,
               "program": {k: c["value"] for k, c in run.checks.items()},
               "setup_s": run.setup_s, "units": len(run.units),
               "check_s": run.extra.get("check_s"),
               "leaves": run.extra.get("leaves"),
               "diagnostics": run.extra.get("diagnostics")}
        if args.control:
            row["control"] = drv.control(run)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del run
    summary = {"program_max": {k: max(r["program"][k] for r in rows)
                               for k in rows[0]["program"]}}
    if args.control:
        ctl = [r["control"] for r in rows]
        summary["control_min"] = {k: min(c[k] for c in ctl) for k in ctl[0]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
