"""The reader of the share of staff-summary sequences computed by K3
(``decode.summary_kernel_share``) on hand-built records, as
test_bench_port_graph_steps.py reads the graph steps."""

import pytest

from bench_port.harness import spec
from bench_port.tests.test_bench_port_program_spans import (
    decode_events, program_records, read, serve_run)
from piano_a2s_tpu_torch.utils import profiling as P

NAME = "decode.summary_kernel_share"
# sos_token's 16 rows and 2 staves x 16 clips in each of 5 bars.
ROWS = 16 + 5 * 2 * 16


def _with_summaries(recs, kernel_rows):
    """program_records with the decoder's summary counters; ``kernel_rows``
    None leaves summary_kernel_rows out (a program without K3)."""
    for r in recs:
        if isinstance(r, P.Span) and r.name == "forward/decoder":
            r.counts["summary_rows"] = ROWS
            if kernel_rows is not None:
                r.counts["summary_kernel_rows"] = kernel_rows
    return recs


@pytest.mark.parametrize("kernel_rows", [ROWS, 5 * 2 * 16, 0])
def test_the_summary_kernel_share(monkeypatch, kernel_rows):
    """Every row K3's (100), all but sos_token's, and none (the packed
    path, counted)."""
    t0 = 10 ** 15
    monkeypatch.setattr(P.RECORDER, "_buf",
                        _with_summaries(program_records(t0), kernel_rows))
    run = serve_run(decode_events(t0))
    assert read(NAME, run) == pytest.approx(100.0 * kernel_rows / ROWS)


def test_no_kernel_counter_reads_none(monkeypatch):
    """No records, no profiled stretch, or forward/decoder spans without
    summary_kernel_rows (a program from before K3): None."""
    t0 = 10 ** 15
    run = serve_run(decode_events(t0))
    monkeypatch.setattr(P.RECORDER, "_buf",
                        _with_summaries(program_records(t0), None))
    assert read(NAME, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf", program_records(t0))
    assert read(NAME, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf", [])
    assert read(NAME, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf",
                        _with_summaries(program_records(t0), ROWS))
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
    assert m["workloads"] == ["serve_f32.offline_caps"]
    layers = {x["layer"] for x in bench["per_layer"]
              if x["name"].startswith("decode.")}
    assert layers == {m["layer"]}
    cell = spec.cell("serve_f32.offline_caps", bench)
    assert NAME in {x["name"] for x in cell.per_layer}
    assert NAME not in {x["name"] for x in spec.cell(
        "pretrain_f32.real_lengths", bench).per_layer}
