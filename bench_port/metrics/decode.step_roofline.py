"""The greedy decoder's share of its roofline: the bound of the note
decoders' steps that the stop groups needed (counts.decode_cost) over the
device time of all the work launched under forward/decoder in the profiled
batches (``Trace.span_device_seconds``, wherever it runs on the card): the
whole decoder's (the bar level, the staff summaries and the signature
heads too, which the bound leaves out, so the share reads low by their
part of the time)."""

from bench_port.harness import counts, readers as R


def read(run):
    units = R.profiled(run)
    t = run.trace.span_device_seconds(["forward/decoder"]) if units else 0.0
    if not t:
        return None
    cfg = run.cell.config
    bound = 0.0
    for u in units:
        ops, nbytes, _ = counts.decode_cost(cfg["model"], cfg["frames"],
                                            u["stops"], run.extra["group"])
        bound += R.bound_s(run, ops, nbytes)
    return 100.0 * bound / t
