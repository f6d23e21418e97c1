"""K1's share of its roofline: the bound of the VQT the profiled batches
needed (nonzero taps, bench_port/harness/counts.py::vqt_cost) over the
device time of K1's kernels."""

from bench_port.harness import counts, readers as R


def read(run):
    units = R.profiled(run)
    t = run.trace.kernel_seconds(R.is_k1) if units else 0.0
    if not t:
        return None
    cfg = run.cell.config
    bound = sum(R.bound_s(run, *counts.vqt_cost(cfg["vqt"], u["clips"],
                                                R.n_samples(run)))
                for u in units)
    return 100.0 * bound / t
