"""The port's span-and-counter recorder (utils/profiling.py) on the CPU.

Off (no torch.profiler recording), ``span`` and ``count`` keep nothing and
open no record_function. Under the profiler each span is a kineto range of
its name and a record on the same host clock; the greedy decode counts its
steps, stop reads and rows on one ``decode/notes`` span a bar (no span a
step), and the teacher-forced step counts each recompute of its backward
sweep.
"""

import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_port.harness import judge
from piano_a2s_tpu_torch import infer as tinfer
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import init_state_dict
from piano_a2s_tpu_torch.ops import vqt as tvqt
from piano_a2s_tpu_torch.train import step as tstep
from piano_a2s_tpu_torch.utils import profiling as P
from test_torch_train import TCFG as TRAIN_CFG, _batch

torch.set_num_threads(2)

CFG = tst.ModelConfig(freq_bins=16, conv_feature_size=32, hidden_size=16,
                      max_bars=2, max_length=(8, 6), note_emb_size=8,
                      staff_emb_size=8)
# A weak model whose stop groups of 16 stop at different steps on _spec's
# 32 clips: per bar, upper groups (1, 1) then (2, 3), lower (6, 6) then
# (1, 2); the loop runs 6 then 3 steps.
SEED, EOS_BIAS, CONV_SCALE, CHUNK = 1, 0.6, 3.0, 16
EVERYTHING = (0, 2 ** 63)


@pytest.fixture(autouse=True)
def empty_recorder():
    P.RECORDER.clear()
    yield
    P.RECORDER.clear()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def _weak_model():
    model = tst.ScoreTranscription(CFG)
    model.load_state_dict(init_state_dict(CFG, SEED))
    model.eval()
    with torch.no_grad():
        for d in (model.decoder.upper_decoder, model.decoder.lower_decoder):
            d.out.bias[CFG.eos] += EOS_BIAS
        for p in model.convstack.parameters():
            p.mul_(CONV_SCALE)
    return model


def _spec(b=32, seed=0):
    """Rows of different scales, so that the clips decode differently."""
    rng = np.random.RandomState(seed)
    scale = rng.choice([0.0, 1, 3, 10, 30, 100], (b, 1, 1, 1))
    return torch.from_numpy((rng.randn(b, 1, 20, 16) * scale)
                            .astype(np.float32))


class _CountingRecordFunction:
    """Stands in for the recorder's record_function and counts the
    ranges it opens."""

    def __init__(self, monkeypatch):
        self.names = []
        real = P.record_function

        def make(name):
            self.names.append(name)
            return real(name)

        monkeypatch.setattr(P, "record_function", make)


def _spans(recs, name):
    return [r for r in recs if isinstance(r, P.Span) and r.name == name]


def _total(recs, counter):
    return sum(r.counts.get(counter, 0) if isinstance(r, P.Span)
               else (r.n if r.name == counter else 0) for r in recs)


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    opened = _CountingRecordFunction(monkeypatch)
    assert not P.active()
    timings = {}
    with P.span("outer"):
        P.count("c", 5)
        with P.span("inner", into=timings, key="inner_s"):
            P.count("c")
    P.count("bare")
    _weak_model()(_spec(b=4), decode_chunk=CHUNK)
    assert opened.names == []
    assert P.records(*EVERYTHING) == []
    # The caller's wall is kept whether tracing is on or not.
    assert set(timings) == {"inner_s"} and timings["inner_s"] > 0


def test_spans_line_up_with_the_kineto_events():
    def body():
        marks = []
        for i in range(8):
            with P.span(f"t/outer{i}"):
                P.count("n", 2)
                with P.span(f"t/inner{i}"):
                    P.count("n", 3)
                    torch.ones(8).sum()
                marks.append(threading.get_ident())
        P.count("bare", 7)
        return marks

    marks, events = _profiled(body)
    recs = P.records(*EVERYTHING)
    kineto = {e.name(): e for e in events if e.name().startswith("t/")}
    offsets = []
    for i in range(8):
        outer, = _spans(recs, f"t/outer{i}")
        inner, = _spans(recs, f"t/inner{i}")
        assert inner.parent is outer and outer.parent is None
        assert inner.thread == outer.thread == marks[i]
        assert (outer.counts, inner.counts) == ({"n": 2}, {"n": 3})
        for rec in (outer, inner):
            ev = kineto[rec.name]
            # The same clock: each record lies inside its kineto range.
            assert ev.start_ns() <= rec.start_ns < rec.end_ns <= ev.end_ns()
            offsets += [rec.start_ns - ev.start_ns(),
                        ev.end_ns() - rec.end_ns]
    assert statistics.median(offsets) < 100_000
    bare, = [r for r in recs if isinstance(r, P.Count)]
    assert (bare.name, bare.n) == ("bare", 7)
    # A window that holds only the first outer span holds nothing more.
    first, = _spans(recs, "t/outer0")
    inner0, = _spans(recs, "t/inner0")
    assert P.records(first.start_ns, first.end_ns) == [first, inner0]


def test_a_window_the_buffer_cut_short_reads_none(monkeypatch):
    monkeypatch.setattr(P.RECORDER, "capacity", 2)

    def body():
        for i in range(3):
            with P.span(f"s{i}"):
                pass

    _profiled(body)
    kept = P.records(*EVERYTHING)
    assert kept is None
    s0, s1 = P.RECORDER._buf[:2]
    # Records before the first one dropped still read whole.
    assert P.records(s0.start_ns, s1.end_ns) == [s0, s1]


def test_the_greedy_decode_counts_its_steps_and_rows(monkeypatch):
    opened = _CountingRecordFunction(monkeypatch)
    model = _weak_model()
    spec = _spec()
    out, events = _profiled(
        lambda: model(spec, decode_chunk=CHUNK))
    aux = out[4]
    recs = P.records(*EVERYTHING)
    stops = np.stack([judge.stop_structure(
        aux[f"{s}_tokens"].numpy(), aux[f"{s}_lengths"].numpy(), CFG.eos,
        CHUNK)[0] for s in ("upper", "lower")], axis=1)   # (bars, 2, G)
    # The model decodes the mixed case the test is for.
    assert stops.tolist() == [[[1, 1], [6, 6]], [[2, 3], [1, 2]]]

    notes = _spans(recs, "decode/notes")
    assert len(notes) == CFG.max_bars
    for bar, span in zip(stops, notes):
        assert span.parent.name == "forward/decoder"
        steps = int(bar.max())
        assert span.counts["note_steps"] == steps
        assert span.counts["rows_computed"] == 2 * spec.shape[0] * steps
        assert span.counts["rows_active"] == int(bar.sum()) * CHUNK
        assert span.counts["stop_read_ns"] > 0
    # Spans go per bar, never per step: the forward's three and a notes
    # span a bar, all records without a kineto range.
    assert sorted(r.name for r in recs) == sorted(
        ["forward/convstack", "forward/encoder", "forward/decoder"]
        + ["decode/notes"] * CFG.max_bars)
    assert opened.names == []
    assert not {r.name for r in recs} & {e.name() for e in events}


def test_the_serving_path_adds_no_host_op_to_the_trace(monkeypatch):
    """A traced greedy decode runs the host ops it runs with the recorder
    made inert, in the same order: kineto links each kernel to its host
    op's id, and the spans shift no id."""
    model = _weak_model()
    spec = _spec()

    def ops():
        _, events = _profiled(lambda: model(spec, decode_chunk=CHUNK))
        return [e.name() for e in events
                if str(e.device_type()).endswith("CPU")]

    traced = ops()
    assert P.records(*EVERYTHING)
    monkeypatch.setattr(P.RECORDER, "span",
                        lambda *a, **k: P.contextlib.nullcontext())
    monkeypatch.setattr(P, "span", P.RECORDER.span)
    assert traced == ops()


def test_the_transcriber_fills_its_timings_from_its_spans():
    vqt = tvqt.VQTConfig(bins_per_octave=4, n_octaves=4, window_size=1024,
                         sample_rate=16000, hop_length=160)
    tr = tinfer.Transcriber(init_state_dict(CFG, SEED), CFG, vqt,
                            max_frame_num=101, device="cpu")
    clips = [np.zeros(8000, np.float32), np.ones(12000, np.float32) * 0.1]
    timings = {}
    untraced = tr.transcribe_batch(clips, timings=timings)
    assert set(timings) == {"host_prep_s", "device_s", "postprocess_s"}
    assert P.records(*EVERYTHING) == []

    traced, _ = _profiled(lambda: tr.transcribe_batch(clips))
    assert traced == untraced
    recs = P.records(*EVERYTHING)
    top = [r.name for r in recs if r.parent is None]
    assert top == ["transcribe/prepare", "transcribe/device",
                   "transcribe/postprocess"]
    device, = _spans(recs, "transcribe/device")
    for name in ("forward/convstack", "forward/encoder", "forward/decoder"):
        span, = _spans(recs, name)
        assert span.parent is device


def test_the_train_step_counts_one_recompute_per_teacher_step(monkeypatch):
    batch = _batch(b=2)
    model = tst.ScoreTranscription(TRAIN_CFG).double()
    model.load_state_dict(init_state_dict(TRAIN_CFG, 3, torch.float64))
    t_step, _ = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), device="cpu")
    counted = []
    real = P.count

    def spy(name, n=1):
        counted.append(name)
        real(name, n)

    monkeypatch.setattr(P, "count", spy)
    _profiled(lambda: t_step(model, batch, torch.Generator().manual_seed(0),
                             0.7))
    recs = P.records(*EVERYTHING)
    steps = TRAIN_CFG.max_bars * max(batch["upper"].shape[-1],
                                     batch["lower"].shape[-1])
    assert counted.count("train.recompute_ns") == steps
    assert _total(recs, "train.recompute_ns") > 0
    backward, = _spans(recs, "train_step/backward")
    # On the CPU autograd runs the recompute on the calling thread, inside
    # the backward's span; on a card, on its own thread, as bare counts.
    assert backward.counts["train.recompute_ns"] == _total(
        recs, "train.recompute_ns")
    # The forward runs the steps without gradients: no count.
    forward, = _spans(recs, "train_step/forward")
    assert "train.recompute_ns" not in forward.counts
