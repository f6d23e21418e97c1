"""Device milliseconds per batch of the work that the ConvStack and the
encoder launch (inside the benchmark's forward/convstack and
forward/encoder ranges, ``Trace.span_device_seconds``), wherever it runs
on the card, in the profiled batches."""

from bench_port.harness import readers as R


def read(run):
    units = R.profiled(run)
    if not units:
        return None
    t = run.trace.span_device_seconds(["forward/convstack",
                                       "forward/encoder"])
    return 1e3 * t / len(units) if t else None
