"""Model operations of the window's batches outside the profiled stretch
(counts.serve_batch_flops: VQT, ConvStack, encoder, bar level, the decode
steps the stop groups needed) over their host wall times the peak."""

from bench_port.harness import readers as R


def read(run):
    units = run.timed_units()
    wall = sum(u["t1"] - u["t0"] for u in units)
    if not wall:
        return None
    flops = sum(R.served_flops(run, u) for u in units)
    return 100.0 * flops / (wall * R.peaks(run)[0])
