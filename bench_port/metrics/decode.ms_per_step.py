"""Host wall of the decoder (forward/decoder) per decode step run, over
the window's batches outside the profiled stretch."""

from bench_port.harness import readers as R


def read(run):
    units = run.timed_units()
    steps = sum(R.decode_steps(u) for u in units)
    if not steps:
        return None
    return 1e3 * sum(u["layers"].get("forward/decoder", 0.0)
                     for u in units) / steps
