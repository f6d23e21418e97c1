"""Where the trace places each device activity: at the host time of its own
launch (the runtime call whose correlation id it carries; for a replayed
graph's kernels, the graph's launch), wherever it runs on the card, and at
its device start only where the trace holds no launch for it. The readers
of spans (``Trace.span_device_seconds``: ranges) and of the program's
records (``program.launched``) place alike, on hand-built events."""

import pytest

from bench_port.harness import program as G
from bench_port.harness.trace import STRETCH, Trace
from bench_port.tests.test_bench_port_program_spans import (
    MAIN, Ev, Events, read, serve_run)
from piano_a2s_tpu_torch.utils import profiling as P

T0 = 10 ** 15
K2 = ("attn_kernel", "gru_kernel", "proj_kernel", "final_kernel")


def _record(name, start, end, counts=None):
    return P.Span(name, start, end, MAIN, None, counts or {})


@pytest.mark.parametrize("ranged", [False, True])
def test_a_kernel_is_placed_by_its_own_launch(ranged):
    """A kernel launched inside the encoder's span that starts on the card
    after the span closed (the card still busy) belongs to the encoder, and
    kineto's link to a host op elsewhere does not move it: a
    record_function range opened before its launch shifts the host ops'
    ids, so that the link names the decoder's launch."""
    enc, dec = (T0 + 100_000, T0 + 200_000), (T0 + 300_000, T0 + 900_000)
    ev = Events()
    ev.span(STRETCH, T0, T0 + 1_000_000)
    ev.span("forward/encoder", *enc)
    ev.span("forward/decoder", *dec)
    if ranged:
        ev.span("bench/probe", T0 + 120_000, T0 + 140_000)
    in_dec = ev.kernel(T0 + 400_000, T0 + 400_010, T0 + 400_050)
    ev.kernel(T0 + 150_000, T0 + 250_000, T0 + 280_000,
              linked=in_dec if ranged else None)
    trace = Trace(ev, MAIN)
    assert trace.unplaced == 0
    assert trace.span_device_seconds(["forward/encoder"]) == \
        pytest.approx(30_000e-9)
    assert trace.span_device_seconds(["forward/decoder"]) == \
        pytest.approx(40e-9)
    n, t = G.launched(trace, [_record("forward/encoder", *enc)])
    assert (n, t) == (1, pytest.approx(30_000e-9))


def _graph(ev, at, start, steps):
    """One cudaGraphLaunch at ``at`` whose replay runs ``steps`` steps of
    K2's four kernels of 1 us back to back from ``start``: every kernel
    carries the graph launch's correlation id."""
    corr = len(ev) + 1
    ev.append(Ev("cuda_runtime", "cudaGraphLaunch", at, at + 5, corr))
    for k in range(4 * steps):
        s = start + 1_000 * k
        ev.append(Ev("kernel", f"(anonymous namespace)::{K2[k % 4]}"
                     "(NoteStepArgs)", s, s + 1_000, corr))


def test_a_replay_counts_wholly_in_the_record_that_launched_it(
        monkeypatch):
    """One graph launched inside a decode/notes record whose 64 kernels
    all start after the record closed: all 64 are the record's, and a
    kernel launched before the record that runs inside it is not."""
    notes = (T0 + 1_000_000, T0 + 2_000_000)
    recs = [_record("forward/decoder", T0 + 500_000, T0 + 50_000_000),
            _record("decode/notes", *notes, {"note_steps": 16})]
    monkeypatch.setattr(P.RECORDER, "_buf", recs)
    ev = Events()
    ev.span(STRETCH, T0, T0 + 100_000_000)
    ev.span("forward/decoder", T0 + 500_000, T0 + 50_000_000)
    ev.kernel(T0 + 900_000, T0 + 1_100_000, T0 + 1_200_000)
    _graph(ev, T0 + 1_500_000, T0 + 2_100_000, 16)
    run = serve_run(ev)
    assert run.trace.unplaced == 0
    n, t = G.launched(run.trace, G.spans(recs, "decode/notes"))
    assert (n, t) == (64, pytest.approx(64_000e-9))
    assert read("decode.launches_per_step", run) == 64 / 16
    assert read("decode.fused_step_share", run) == pytest.approx(100.0)
    notes_share = read("decode.notes_roofline", run)
    step_share = read("decode.step_roofline", run)
    # The decoder's range holds the replay and the kernel before it.
    assert notes_share == pytest.approx(step_share * 164_000 / 64_000)


def test_an_activity_without_its_launch_falls_back_to_its_start():
    """A kernel and a copy whose launches the trace lacks are placed at
    their device start, and counted in ``unplaced``."""
    span = (T0 + 100_000, T0 + 200_000)
    ev = Events()
    ev.span(STRETCH, T0, T0 + 1_000_000)
    ev.span("forward/encoder", *span)
    ev.kernel(T0 + 110_000, T0 + 120_000, T0 + 121_000)
    ev.append(Ev("kernel", "orphan", T0 + 150_000, T0 + 152_000, corr=999))
    ev.append(Ev("gpu_memcpy", "Memcpy DtoH", T0 + 300_000, T0 + 301_000,
                 corr=998))
    trace = Trace(ev, MAIN)
    assert trace.unplaced == 2
    assert trace.span_device_seconds(["forward/encoder"]) == \
        pytest.approx(3_000e-9)
    n, t = G.launched(trace, [_record("forward/encoder", *span)])
    assert (n, t) == (2, pytest.approx(3_000e-9))
