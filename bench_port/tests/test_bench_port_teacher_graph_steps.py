"""The reader of the share of teacher-forced steps run in CUDA graph
replays (``train.graph_step_share``) on hand-built records: counts on the
main thread's spans (the forward's) and bare counts from autograd's thread
(the backward sweep's, on a card), as the program keeps them."""

import pytest

from bench_port.harness import spec
from bench_port.harness.record import Run
from bench_port.harness.trace import STRETCH, Trace
from bench_port.tests.test_bench_port_program_spans import (MAIN, OTHER,
                                                            Events, read)
from piano_a2s_tpu_torch.utils import profiling as P

NAME = "train.graph_step_share"
CELL = "pretrain_f32.real_lengths"


def _train_run(monkeypatch, recs):
    t0 = 10 ** 15
    monkeypatch.setattr(P.RECORDER, "_buf", recs(t0))
    ev = Events()
    ev.span(STRETCH, t0, t0 + 20_000_000)
    ev.kernel(t0 + 5, t0 + 10, t0 + 20)
    run = Run(cell=spec.cell(CELL), seed=1, seconds=1.0, traced=True)
    run.trace = Trace(ev, MAIN)
    return run


def _step(t0, graph_steps):
    """One profiled step: five bars of 64 steps, forward counts on the
    decoder's span, the sweep's as bare counts on autograd's thread; a
    bare count before the stretch, which the window leaves out."""
    counts = {"teacher_steps": 5 * 64, "teacher_graph_steps": graph_steps}
    recs = [P.Count("teacher_steps", t0 - 5, 64, OTHER),
            P.Span("forward/decoder", t0 + 1_000, t0 + 2_000_000, MAIN,
                   None, dict(counts))]
    for i in range(5):
        at = t0 + 3_000_000 + 1_000_000 * i
        recs.append(P.Count("teacher_steps", at, 64, OTHER))
        if graph_steps:
            recs.append(P.Count("teacher_graph_steps", at, 64, OTHER))
    return recs


@pytest.mark.parametrize("graph_steps, share", [(320, 100.0), (0, 0.0)])
def test_the_graph_step_share(monkeypatch, graph_steps, share):
    run = _train_run(monkeypatch, lambda t0: _step(t0, graph_steps))
    assert read(NAME, run) == pytest.approx(share)


def test_a_program_without_the_counters_reads_none(monkeypatch):
    """A program from before the counters (only the recompute's), no
    records, or no profiled stretch: None."""
    run = _train_run(monkeypatch, lambda t0: [P.Span(
        "train_step/backward", t0 + 1_000, t0 + 9_000, MAIN, None,
        {"train.recompute_ns": 10})])
    assert read(NAME, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf", [])
    assert read(NAME, run) is None
    monkeypatch.delattr(P, "records")
    assert read(NAME, run) is None
    run.trace = None
    assert read(NAME, run) is None


def test_the_metric_is_declared_for_the_training_cell():
    bench = spec.benchmark()
    m, = [x for x in bench["per_layer"] if x["name"] == NAME]
    assert (m["source"], m["unit"], m["better"], m["moves"]) == (
        "program_counter", "%", "higher", "train_clips_per_s")
    assert m["layer"] == "train step (train/step.py)"
    assert NAME in {x["name"] for x in spec.cell(CELL, bench).per_layer}
