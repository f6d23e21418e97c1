"""Share of the profiled stretch in which no kernel, copy or set ran."""

from bench_port.harness import readers as R


def read(run):
    return R.idle_pct(run)
