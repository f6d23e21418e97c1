"""Share of the backward's host wall spent recomputing the checkpointed
teacher-forced steps: the program's train.recompute_ns counters (made on
whichever thread autograd runs the recompute) over the walls of its
train_step/backward spans, in the profiled steps."""

from bench_port.harness import program as G


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    backward = G.wall_s(G.spans(recs, "train_step/backward"))
    if not backward:
        return None
    return 100.0 * 1e-9 * G.total(recs, "train.recompute_ns") / backward
