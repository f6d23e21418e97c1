"""The readers of the program's own spans and counters on hand-built
records and a hand-built trace (the CPU has no device trace to read).

The program keeps its records in ``piano_a2s_tpu_torch.utils.profiling``
on the profiler's host clock; the readers window them to the profiled
stretch, and read None from a program without them (an older commit) or
from a window the recorder cut short.
"""

import numpy as np
import pytest

from bench_port.harness import spec
from bench_port.harness.record import Run
from bench_port.harness.trace import STRETCH, Trace
from piano_a2s_tpu_torch.utils import profiling as P

MAIN, OTHER = 7, 8
NEW = ("decode.launches_per_step", "decode.host_us_per_step",
       "decode.active_share", "decode.notes_roofline", "transcribe.host_ms",
       "train.recompute_share")
CAPS = np.array([[[398], [189]]] * 5)             # (bars, 2, groups)


class Ev:
    """A kineto event as Trace reads it."""

    def __init__(self, act, name, start, end, corr=0, tid=MAIN, linked=None):
        self._v = (act, name, start, end, corr, tid,
                   corr if linked is None else linked)

    def activity_type(self):
        return self._v[0]

    def name(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[6]

    def start_thread_id(self):
        return self._v[5]


class Events(list):
    def span(self, name, start, end, tid=MAIN):
        self.append(Ev("user_annotation", name, start, end, tid=tid))

    def kernel(self, at, start, end, name="gemv", linked=None):
        """A kernel launched at ``at`` that ran from ``start`` to ``end``;
        ``linked``: the id of the host op kineto links it to, where that
        is not its launch's."""
        corr = len(self) + 1
        self.append(Ev("cuda_runtime", "cudaLaunchKernel", at, at + 5, corr))
        self.append(Ev("kernel", name, start, end, corr, linked=linked))
        return corr


def read(name, run):
    return spec.metric_reader(name)(run)


def serve_run(events):
    run = Run(cell=spec.cell("serve_f32.offline_caps"), seed=1, seconds=1.0,
              traced=True)
    run.trace = Trace(events, MAIN)
    run.units = [{"profiled": True, "clips": 16, "stops": CAPS}]
    run.extra["group"] = 16
    return run


def offline_events(program_spans=None):
    """One batch: the benchmark's LayerSpans ranges around the ConvStack,
    the encoder and the decoder, each with kernels launched inside; the
    program's ranges of the same names around them ("outer"), inside them
    ("inner") or absent (None), launching nothing of their own."""
    ev = Events()
    ev.span(STRETCH, 0, 1_000_000)
    layers = {"forward/convstack": (1_000, 10_000),
              "forward/encoder": (11_000, 20_000),
              "forward/decoder": (21_000, 900_000)}
    for name, (s, e) in layers.items():
        ev.span(name, s, e)
        if program_spans == "outer":
            ev.span(name, s - 100, e + 100)
        elif program_spans == "inner":
            ev.span(name, s + 100, e - 100)
        for at in range(s + 200, e - 200, (e - s) // 4):
            ev.kernel(at, at + 10, at + 60)
    ev.kernel(950_000, 950_010, 950_070)          # outside every span
    return ev


@pytest.mark.parametrize("program_spans", ["outer", "inner"])
def test_layer_readings_do_not_move_when_program_spans_nest(program_spans):
    base = serve_run(offline_events())
    nested = serve_run(offline_events(program_spans))
    for name in ("encode.device_ms.offline", "decode.step_roofline"):
        value = read(name, base)
        assert value is not None and value > 0
        assert read(name, nested) == value, name


def program_records(t0):
    """One profiled batch of 5 bars at the caps: per bar a decode/notes
    span with its counters, inside forward/decoder; the Transcriber's host
    stages; a count outside the stretch that no reader may see."""
    recs = [P.Count("rows_active", t0 - 10, 10 ** 9, MAIN)]
    prep = P.Span("transcribe/prepare", t0 + 100, t0 + 2_000_100, MAIN, None)
    dev = P.Span("transcribe/device", t0 + 2_000_200, t0 + 800_000_000,
                 MAIN, None)
    decoder = P.Span("forward/decoder", t0 + 2_500_000, t0 + 700_000_000,
                     MAIN, dev)
    recs += [prep, dev, decoder]
    for b in range(5):
        s = t0 + 3_000_000 + b * 100_000_000
        recs.append(P.Span("decode/notes", s + 1_000_000, s + 81_000_000,
                           MAIN, decoder,
                           {"note_steps": 398,
                            "stop_read_ns": 20_000_000,
                            "rows_computed": 2 * 16 * 398,
                            "rows_active": 16 * (398 + 189)}))
    recs.append(P.Span("transcribe/postprocess", t0 + 800_000_100,
                       t0 + 803_000_100, MAIN, None))
    return recs


def decode_events(t0):
    """The kineto side of program_records: the benchmark's forward/decoder
    range (the program's spans keep none), three kernels launched in each
    decode/notes span, and two a bar launched outside them (the bar level)
    but inside forward/decoder."""
    ev = Events()
    ev.span(STRETCH, t0, t0 + 900_000_000)
    ev.span("forward/decoder", t0 + 2_500_000, t0 + 700_000_000)
    elsewhere = None
    for b in range(5):
        s = t0 + 3_000_000 + b * 100_000_000
        for k in range(3):
            at = s + 2_000_000 + k * 1_000_000
            # From the second bar on, kineto links the third to a host op
            # whose id is the first bar's last launch's, outside any
            # decode/notes span: the readers do not go by that link.
            ev.kernel(at, at + 100, at + 100_100,
                      linked=elsewhere if k == 2 else None)
        for at in (s + 500_000, s + 85_000_000):
            last = ev.kernel(at, at + 100, at + 50_100)
        elsewhere = elsewhere or last
    return ev


@pytest.fixture
def recorded(monkeypatch):
    """The program's recorder holding program_records."""
    t0 = 10 ** 15
    monkeypatch.setattr(P.RECORDER, "_buf", program_records(t0))
    return serve_run(decode_events(t0))


def test_the_decode_readers(recorded):
    run = recorded
    # The 15 that run inside the decode/notes spans, and not the bar
    # level's 10.
    assert read("decode.launches_per_step", run) == 15 / (5 * 398)
    # (80 ms of wall less 20 ms of stop reads) a bar, over its 398 steps.
    assert read("decode.host_us_per_step", run) == pytest.approx(
        5 * 60_000 / (5 * 398))
    assert read("decode.active_share", run) == pytest.approx(
        100.0 * (398 + 189) / (2 * 398))
    notes = read("decode.notes_roofline", run)
    step = read("decode.step_roofline", run)
    # The notes' bound over 15 kernels of 100 us; the decoder's over those
    # and the bar level's 10 of 50 us.
    assert notes == pytest.approx(step * (15 * 100 + 10 * 50) / (15 * 100))
    assert notes > step
    # 2 ms of preparing and 3 ms of postprocessing in the one batch.
    assert read("transcribe.host_ms", run) == pytest.approx(5.0)


def test_the_recompute_share(monkeypatch):
    t0 = 10 ** 15
    backward = P.Span("train_step/backward", t0 + 1_000, t0 + 10_001_000,
                      MAIN, None, {"train.recompute_ns": 1_000_000})
    # The backward's recomputes: one counted on the main thread (as on the
    # CPU), three on autograd's thread, one before the stretch.
    recs = [P.Count("train.recompute_ns", t0 - 5, 10 ** 9, OTHER), backward]
    recs += [P.Count("train.recompute_ns", t0 + 2_000_000 * i, 1_000_000,
                     OTHER) for i in (1, 2, 3)]
    monkeypatch.setattr(P.RECORDER, "_buf", recs)
    ev = Events()
    ev.span(STRETCH, t0, t0 + 20_000_000)
    ev.kernel(t0 + 5, t0 + 10, t0 + 20)
    run = Run(cell=spec.cell("pretrain_f32.real_lengths"), seed=1,
              seconds=1.0, traced=True)
    run.trace = Trace(ev, MAIN)
    assert read("train.recompute_share", run) == pytest.approx(40.0)


def test_a_program_without_records_reads_none(recorded, monkeypatch):
    run = recorded
    monkeypatch.setattr(P.RECORDER, "_lost_at", run.trace.t1)
    for name in NEW:
        assert read(name, run) is None, name
    monkeypatch.delattr(P, "records")
    for name in NEW:
        assert read(name, run) is None, name
    run.trace = None
    for name in NEW:
        assert read(name, run) is None, name


def test_every_new_metric_is_declared_for_its_cell():
    bench = spec.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["source"] in ("program_span", "program_counter")
        cell = spec.cell(m["workloads"][0], bench)
        assert name in {x["name"] for x in cell.per_layer}
        assert m["moves"] in {x["name"] for x in cell.end_to_end}
