"""The reader of the share of note decoder steps run by the step kernel
(``decode.fused_step_share``) on hand-built records and a hand-built
device trace, as test_bench_port_graph_steps.py reads the graph steps."""

import pytest

from bench_port.harness import spec
from bench_port.tests.test_bench_port_program_spans import (
    decode_events, program_records, read, serve_run)
from piano_a2s_tpu_torch.utils import profiling as P

NAME = "decode.fused_step_share"
K2_ATTN = "(anonymous namespace)::attn_kernel(NoteStepArgs)"


def _with_k2_kernels(ev, t0, per_bar):
    """``per_bar`` K2 attention kernels in each of program_records' five
    decode/notes spans, each beside K2's three other kernels, and one
    attention kernel outside every span, which no step counts."""
    for b in range(5):
        s = t0 + 3_000_000 + b * 100_000_000 + 5_000_000
        for k in range(per_bar):
            at = s + k * 150_000
            ev.kernel(at, at + 100, at + 20_100, name=K2_ATTN)
            for other in ("gru_kernel", "proj_kernel", "final_kernel"):
                ev.kernel(at, at + 20_200, at + 20_300,
                          name=f"(anonymous namespace)::{other}"
                               "(NoteStepArgs)")
    ev.kernel(t0 + 850_000_000, t0 + 850_000_100, t0 + 850_020_100,
              name=K2_ATTN)
    return ev


@pytest.mark.parametrize("share", [1.0, 0.5, 0.25])
def test_the_fused_step_share(monkeypatch, share):
    """398 steps a bar (program_records' note_steps), as many attention
    kernels a bar as there are fused steps."""
    t0 = 10 ** 15
    monkeypatch.setattr(P.RECORDER, "_buf", program_records(t0))
    fused = int(share * 398)
    run = serve_run(_with_k2_kernels(decode_events(t0), t0, fused))
    assert read(NAME, run) == pytest.approx(100.0 * fused / 398)


def test_no_k2_kernels_reads_none(monkeypatch):
    """A trace with no K2 kernel in the spans (a program without the
    kernel), no records, or no profiled stretch: None."""
    t0 = 10 ** 15
    monkeypatch.setattr(P.RECORDER, "_buf", program_records(t0))
    assert read(NAME, serve_run(decode_events(t0))) is None
    run = serve_run(_with_k2_kernels(decode_events(t0), t0, 398))
    assert read(NAME, run) == pytest.approx(100.0)
    monkeypatch.setattr(P.RECORDER, "_buf", [])
    assert read(NAME, run) is None
    monkeypatch.delattr(P, "records")
    assert read(NAME, run) is None
    run.trace = None
    assert read(NAME, run) is None


def test_the_metric_is_declared_for_the_offline_cell():
    bench = spec.benchmark()
    m, = [x for x in bench["per_layer"] if x["name"] == NAME]
    assert (m["source"], m["unit"], m["better"], m["moves"]) == (
        "device_trace", "%", "higher", "clips_per_s")
    assert m["workloads"] == ["serve_f32.offline_caps"]
    layers = {x["layer"] for x in bench["per_layer"]
              if x["name"].startswith("decode.")}
    assert layers == {m["layer"]}
    cell = spec.cell("serve_f32.offline_caps", bench)
    assert NAME in {x["name"] for x in cell.per_layer}
