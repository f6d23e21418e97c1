"""The readers of K2's step on the card (``decode.k2_us_per_step``) and of
how often its kernels overlap the kernel before them
(``decode.k2_overlap_share``), on hand-built records and a hand-built
trace, as test_bench_port_encoder_gru.py reads K4's."""

import pytest

from bench_port.harness import spec
from bench_port.harness.trace import STRETCH
from bench_port.tests.test_bench_port_program_spans import (
    Events, program_records, read, serve_run)
from piano_a2s_tpu_torch.utils import profiling as P

STEP, OVERLAP = "decode.k2_us_per_step", "decode.k2_overlap_share"
# As torch.profiler names them on the H100, with each step's durations.
K2 = (("(anonymous namespace)::attn_kernel(NoteStepArgs)", 30_000),
      ("(anonymous namespace)::gru_kernel(NoteStepArgs)", 5_000),
      ("(anonymous namespace)::proj_kernel(NoteStepArgs, int)", 6_000),
      ("(anonymous namespace)::final_kernel(NoteStepArgs)", 2_000))
STEPS, BARS, REPLAYS = 16, 2, 2            # steps a replay, replays a bar


def _records(t0, steps_per_bar):
    """``BARS`` decode/notes spans, each counting ``steps_per_bar``."""
    recs = program_records(t0)[:4]           # no decode/notes of its own
    for b in range(BARS):
        s = t0 + 3_000_000 + b * 100_000_000
        recs.append(P.Span("decode/notes", s, s + 50_000_000, 7, None,
                           {"note_steps": steps_per_bar}))
    return recs


def _events(t0, gaps):
    """Each bar's replays of STEPS steps, K2's four kernels a step, each
    starting ``gaps[k]`` ns after the kernel before it ended (less than 0:
    before it ended; the first of a replay 1 ms after the last replay);
    after each replay a stop reduction, which no reader counts, and a
    kernel outside the stretch."""
    ev = Events()
    ev.span(STRETCH, t0, t0 + 900_000_000)
    for b in range(BARS):
        end = t0 + 4_000_000 + b * 100_000_000
        for r in range(REPLAYS):
            end += 1_000_000
            first = True
            for _ in range(STEPS):
                for k, (name, ns) in enumerate(K2):
                    start = end if first else end + gaps[k]
                    first = False
                    ev.kernel(start - 10_000, start, start + ns, name=name)
                    end = start + ns
            ev.kernel(end, end + 2_000, end + 5_000,
                      name="void at::native::reduce_kernel<512, 1>")
    ev.kernel(t0 + 950_000_000, t0 + 950_000_100, t0 + 950_030_100,
              name=K2[0][0])
    return ev


def _span_ns(gaps):
    """A replay's span on the card: its kernels and the gaps between."""
    return STEPS * sum(ns for _, ns in K2) + sum(
        gaps[k % 4] for k in range(1, 4 * STEPS))


# Gaps before gru, proj, final and the next step's attn (index 0).
APART, PDL, HALF = (1_000,) * 4, (-2_000,) * 4, (1_000, -2_000, 1_000, -2_000)


@pytest.mark.parametrize("gaps", [APART, PDL, HALF])
def test_the_k2_time_a_step(monkeypatch, gaps):
    """A replay's kernels, gaps and overlaps counted once, the time between
    replays not; over the records' note_steps."""
    t0 = 10 ** 15
    monkeypatch.setattr(P.RECORDER, "_buf",
                        _records(t0, REPLAYS * STEPS))
    run = serve_run(_events(t0, gaps))
    want = _span_ns(gaps) * 1e-3 / STEPS
    assert read(STEP, run) == pytest.approx(want)
    assert {APART: 46.9375, PDL: 35.125}.get(gaps, want) == \
        pytest.approx(want)


@pytest.mark.parametrize("gaps,share", [(APART, 0.0), (PDL, 100.0),
                                        (HALF, 100.0 * 32 / 63)])
def test_the_k2_overlap_share(gaps, share):
    """63 boundaries a replay (its first kernel follows the host's stop
    read); where half the kernels start early, 32 of them (attn -> gru and
    proj -> final, 16 each)."""
    run = serve_run(_events(10 ** 15, gaps))
    assert read(OVERLAP, run) == pytest.approx(share)


def test_no_k2_kernel_reads_none(monkeypatch):
    """A trace without K2's kernels (a program without K2), no decode/notes
    records, no records, or no profiled stretch: None."""
    t0 = 10 ** 15
    monkeypatch.setattr(P.RECORDER, "_buf", _records(t0, REPLAYS * STEPS))
    bare = Events()
    bare.span(STRETCH, t0, t0 + 900_000_000)
    bare.kernel(t0 + 10, t0 + 20, t0 + 30_000)
    for name in (STEP, OVERLAP):
        assert read(name, serve_run(bare)) is None, name
    run = serve_run(_events(t0, PDL))
    assert read(STEP, run) == pytest.approx(35.125)
    monkeypatch.setattr(P.RECORDER, "_buf", program_records(t0)[:4])
    assert read(STEP, run) is None
    monkeypatch.setattr(P.RECORDER, "_buf", [])
    assert read(STEP, run) is None
    monkeypatch.delattr(P, "records")
    assert read(STEP, run) is None
    assert read(OVERLAP, run) == 100.0
    run.trace = None
    for name in (STEP, OVERLAP):
        assert read(name, run) is None, name


@pytest.mark.parametrize("name,unit", [(STEP, "us"), (OVERLAP, "%")])
def test_the_metrics_are_declared_for_the_offline_cell(name, unit):
    bench = spec.benchmark()
    m, = [x for x in bench["per_layer"] if x["name"] == name]
    better = "lower" if name == STEP else "higher"
    assert (m["source"], m["unit"], m["better"], m["moves"]) == (
        "device_trace", unit, better, "clips_per_s")
    assert m["workloads"] == ["serve_f32.offline_caps"]
    layers = {x["layer"] for x in bench["per_layer"]
              if x["name"].startswith("decode.")}
    assert layers == {m["layer"]}
    assert name in {x["name"] for x in spec.cell(
        "serve_f32.offline_caps", bench).per_layer}
    assert name not in {x["name"] for x in spec.cell(
        "pretrain_f32.real_lengths", bench).per_layer}
