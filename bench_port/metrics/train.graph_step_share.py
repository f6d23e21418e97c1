"""Share of the teacher-forced note decoders' steps that ran inside CUDA
graph replays: the program's teacher_graph_steps over its teacher_steps
counters (each bar's forward and its backward sweep count both, on any
thread), in the profiled steps. None where nothing counts teacher_steps (a
program without the counters)."""

from bench_port.harness import program as G


def read(run):
    recs = G.records(run)
    if not recs:
        return None
    steps = G.total(recs, "teacher_steps")
    if not steps:
        return None
    return 100.0 * G.total(recs, "teacher_graph_steps") / steps
