"""The readers of K4, the hand-written encoder recurrence: the share of
the encoder's rows it computed (``encode.gru_kernel_share``, counters) and
its device time a step (``encode.gru_us_per_step``, device trace), on
hand-built records and a hand-built trace, as
test_bench_port_summary_kernel_rows.py reads K3's share."""

import pytest

from bench_port.harness import spec
from bench_port.harness.trace import STRETCH
from bench_port.tests.test_bench_port_program_spans import (
    Events, program_records, read, serve_run)
from piano_a2s_tpu_torch.utils import profiling as P

SHARE, STEP = "encode.gru_kernel_share", "encode.gru_us_per_step"
# As torch.profiler names it on the H100.
K4_KERNEL = "(anonymous namespace)::encoder_gru_kernel(EncoderGruArgs, int)"
FRAMES = 1201


def _records(t0, batches, rows, kernel_rows):
    """program_records with ``batches`` forward/encoder spans, each
    counting ``rows`` encoder rows and ``kernel_rows`` of K4's (None: no
    such counter, a program without K4)."""
    recs = program_records(t0)
    for b in range(batches):
        counts = {"encoder_rows": rows}
        if kernel_rows is not None:
            counts["encoder_kernel_rows"] = kernel_rows
        s = t0 + 1_000_000 + b * 100_000
        recs.append(P.Span("forward/encoder", s, s + 50_000, 7, None,
                           counts))
    return recs


def _events(t0, layer_ns, launches):
    """A profiled stretch with ``launches`` K4 kernels of ``layer_ns`` each
    and cuDNN's kernels beside them, which the reader must not count."""
    ev = Events()
    ev.span(STRETCH, t0, t0 + 900_000_000)
    for k in range(launches):
        at = t0 + 1_000_000 + k * 10_000_000
        ev.kernel(at, at + 100, at + 100 + layer_ns, name=K4_KERNEL)
        ev.kernel(at, at + 200 + layer_ns, at + 300 + layer_ns,
                  name="void gemmSN_TN_kernel<float>(cublasGemmSmallNParams)")
    return ev


@pytest.mark.parametrize("kernel_rows", [16, 8, 0])
def test_the_gru_kernel_share(monkeypatch, kernel_rows):
    """Every row K4's (100), half, and none (nn.GRU, counted)."""
    t0 = 10 ** 15
    monkeypatch.setattr(P.RECORDER, "_buf", _records(t0, 2, 16, kernel_rows))
    run = serve_run(_events(t0, 2_000_000, 4))
    assert read(SHARE, run) == pytest.approx(100.0 * kernel_rows / 16)


def test_no_kernel_counter_reads_none(monkeypatch):
    """No encoder spans, spans without encoder_kernel_rows (a program
    without K4), no records, or no profiled stretch: None."""
    t0 = 10 ** 15
    run = serve_run(_events(t0, 2_000_000, 4))
    monkeypatch.setattr(P.RECORDER, "_buf", program_records(t0))
    assert read(SHARE, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf", _records(t0, 2, 16, None))
    assert read(SHARE, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf", [])
    assert read(SHARE, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf", _records(t0, 2, 16, 16))
    assert read(SHARE, run) == 100.0
    monkeypatch.delattr(P, "records")
    assert read(SHARE, run) is None
    run.trace = None
    assert read(SHARE, run) is None


@pytest.mark.parametrize("batches", [1, 2])
def test_the_gru_time_a_step(monkeypatch, batches):
    """Two launches a call of 2.4 ms each: 2 us a step of 1,201 frames."""
    t0 = 10 ** 15
    monkeypatch.setattr(P.RECORDER, "_buf", _records(t0, batches, 16, 16))
    run = serve_run(_events(t0, 2_402_000, 2 * batches))
    assert run.cell.config["frames"] == FRAMES
    assert read(STEP, run) == pytest.approx(2.0)


def test_no_k4_kernel_reads_none(monkeypatch):
    """A trace without K4's kernels (a program without K4), no encoder
    spans, no records, or no profiled stretch: None."""
    t0 = 10 ** 15
    monkeypatch.setattr(P.RECORDER, "_buf", _records(t0, 2, 16, None))
    assert read(STEP, serve_run(_events(t0, 2_000_000, 0))) is None
    run = serve_run(_events(t0, 2_402_000, 4))
    assert read(STEP, run) == pytest.approx(2.0)
    monkeypatch.setattr(P.RECORDER, "_buf", program_records(t0))
    assert read(STEP, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf", [])
    assert read(STEP, run) is None
    monkeypatch.delattr(P, "records")
    assert read(STEP, run) is None
    run.trace = None
    assert read(STEP, run) is None


@pytest.mark.parametrize("name,source,unit,better", [
    (SHARE, "program_counter", "%", "higher"),
    (STEP, "device_trace", "us", "lower")])
def test_the_metrics_are_declared_for_the_offline_cell(name, source, unit,
                                                       better):
    bench = spec.benchmark()
    m, = [x for x in bench["per_layer"] if x["name"] == name]
    assert (m["source"], m["unit"], m["better"], m["moves"]) == (
        source, unit, better, "clips_per_s")
    assert m["workloads"] == ["serve_f32.offline_caps"]
    layers = {x["layer"] for x in bench["per_layer"]
              if x["name"].startswith("encode.")}
    assert layers == {m["layer"]}
    assert name in {x["name"] for x in spec.cell(
        "serve_f32.offline_caps", bench).per_layer}
    assert name not in {x["name"] for x in spec.cell(
        "pretrain_f32.real_lengths", bench).per_layer}
