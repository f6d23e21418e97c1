"""The note decoders' share of their roofline: the bound of the steps
the stop groups needed (counts.decode_cost, as decode.step_roofline) over
the device time of the work launched inside the program's decode/notes
spans only (``program.launched``; not the bar level, the heads or the
staff summaries), in the profiled batches."""

from bench_port.harness import counts, program as G, readers as R


def read(run):
    units = R.profiled(run)
    recs = G.records(run)
    if not units or not recs:
        return None
    _, t = G.launched(run.trace, G.spans(recs, "decode/notes"))
    if not t:
        return None
    cfg = run.cell.config
    bound = 0.0
    for u in units:
        ops, nbytes, _ = counts.decode_cost(cfg["model"], cfg["frames"],
                                            u["stops"], run.extra["group"])
        bound += R.bound_s(run, ops, nbytes)
    return 100.0 * bound / t
