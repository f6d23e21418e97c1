"""Model operations of the window's steps outside the profiled stretch
(counts.train_step_flops: the forward at the targets' widths, twice that
for the backward, the VQT once) over their wall times the peak."""

from bench_port.harness import counts, readers as R


def read(run):
    units = run.timed_units()
    wall = units[-1]["t1"] - units[0]["t0"] if units else 0.0
    if not wall:
        return None
    cfg = run.cell.config
    per_step = counts.train_step_flops(
        cfg["model"], cfg["vqt"], run.cell.traffic["batch"], R.n_samples(run),
        cfg["frames"], run.extra["widths"])
    return 100.0 * per_step * len(units) / (wall * R.peaks(run)[0])
