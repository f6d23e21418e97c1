"""The reader of the share of note decoder steps run in CUDA graph
replays (``decode.graph_step_share``) on hand-built records, as
test_bench_port_program_spans.py reads the other decoder counters."""

import pytest

from bench_port.harness import spec
from bench_port.tests.test_bench_port_program_spans import (
    decode_events, program_records, read, serve_run)
from piano_a2s_tpu_torch.utils import profiling as P

NAME = "decode.graph_step_share"


def _with_graph_steps(recs, share):
    for r in recs:
        if isinstance(r, P.Span) and r.name == "decode/notes":
            r.counts["graph_steps"] = int(share * r.counts["note_steps"])
    return recs


@pytest.mark.parametrize("share", [1.0, 0.5])
def test_the_graph_step_share(monkeypatch, share):
    t0 = 10 ** 15
    recs = _with_graph_steps(program_records(t0), share)
    monkeypatch.setattr(P.RECORDER, "_buf", recs)
    run = serve_run(decode_events(t0))
    assert read(NAME, run) == pytest.approx(100.0 * share, abs=0.06)


def test_no_graph_steps_reads_none(monkeypatch):
    """No records, no profiled stretch, or decode/notes spans without the
    counter (a program from before the graph path): None."""
    t0 = 10 ** 15
    run = serve_run(decode_events(t0))
    monkeypatch.setattr(P.RECORDER, "_buf", program_records(t0))
    assert read(NAME, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf", [])
    assert read(NAME, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf",
                        _with_graph_steps(program_records(t0), 1.0))
    assert read(NAME, run) == 100.0
    monkeypatch.delattr(P, "records")
    assert read(NAME, run) is None
    run.trace = None
    assert read(NAME, run) is None


def test_the_metric_is_declared_for_the_offline_cell():
    bench = spec.benchmark()
    m, = [x for x in bench["per_layer"] if x["name"] == NAME]
    assert (m["source"], m["unit"], m["better"], m["moves"]) == (
        "program_counter", "%", "higher", "clips_per_s")
    layers = {x["layer"] for x in bench["per_layer"]
              if x["name"].startswith("decode.")}
    assert layers == {m["layer"]}
    cell = spec.cell("serve_f32.offline_caps", bench)
    assert NAME in {x["name"] for x in cell.per_layer}
