"""The correctness check at a tiny size on the CPU: the reference agrees
with the program on both entries, and the check fails the control (the
reference in TF32 in the program's place) and the faults a run can have.

The runs here skip the look for a card and drive the rest of a run (set-up,
window, check) on the CPU, where the program takes the VQT's plain path.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_port.entries import offline, train
from bench_port.harness import judge
from bench_port.harness.faults import planted
from bench_port.harness.record import Run
from bench_port.tests.tiny import tiny_cell

SEED = 2 ** 31 + 12345          # more than 32 signed bits hold


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def serve_run(seed=SEED, **traffic):
    cell = tiny_cell("serve_f32.offline_caps", batch=4, **traffic)
    run = Run(cell=cell, seed=seed, seconds=0.3, traced=False, device="cpu")
    offline.run(run)
    return run


def train_run(seed=SEED):
    cell = tiny_cell("pretrain_f32.real_lengths", batch=4, pool=4)
    run = Run(cell=cell, seed=seed, seconds=0.3, traced=False, device="cpu")
    train.run(run)
    return run


def test_served_batches_agree_with_the_reference():
    run = serve_run()
    assert run.correct, run.checks
    assert run.checks["judged_positions"]["value"] == 4 * 2 * (12 + 8) + 16
    assert run.checks["logp_err"]["value"] < 1e-5


def test_served_stops_are_judged():
    # An <eos> bias makes every clip stop early; the stop groups and the
    # lengths derived from the tokens must match the program's.
    run = serve_run(eos_bias=[6.0, 6.0])
    assert run.correct, run.checks
    u = run.units[0]
    assert u["stops"].max() < 12
    assert run.checks["judged_positions"]["value"] < 4 * 2 * (12 + 8) + 16


def test_training_steps_agree_with_the_reference():
    run = train_run()
    assert run.correct, run.checks
    for name in ("loss1_gap", "grad_gap", "win_change_median_gap"):
        assert run.checks[name]["value"] < 1e-4
    assert run.checks["window_nonfinite"]["value"] == 0
    # The judged step is a window step, past set-up's anchor steps.
    assert run.extra["window_step"]["index"] >= 4


def test_the_control_fails_the_serving_check():
    run = serve_run()
    ctl = offline.control(run)
    lim = run.cell.limits
    assert ctl["logp_err"] > lim["logp_err"] or \
        ctl["token_gap"] > lim["token_gap"], ctl


def test_the_control_fails_the_training_check():
    run = train_run()
    ctl = train.control(run)
    lim = run.cell.limits
    assert any(ctl[k] > lim[k] for k in lim if k.endswith("_gap")), ctl


def test_stop_structure_counts_late_tokens_and_lengths():
    eos = 146
    toks = np.zeros((2, 1, 6), np.int64)
    toks[0, 0, :3] = [5, eos, 7]
    toks[1, 0, :4] = [5, 5, 5, eos]
    stops, derived, bad = judge.stop_structure(toks, np.array([[2], [4]]),
                                               eos, 2)
    assert stops.tolist() == [[4]] and derived.tolist() == [[2], [4]]
    assert bad == 0
    toks[0, 0, 5] = 9                   # a token after the group stopped
    assert judge.stop_structure(toks, derived, eos, 2)[2] == 1
    assert judge.stop_structure(toks[:, :, :], np.array([[3], [4]]), eos,
                                2)[2] == 2


# -- faults of the timed path: each must come out not correct ---------------

@pytest.mark.parametrize("fault", ["alter_served_token",
                                   "half_batch_served"])
def test_a_serving_fault_is_not_correct(fault):
    with planted(fault):
        assert not serve_run().correct


def _k2_twin(fast):
    """K2's step as its wrapper takes it (``note_step_cuda``), in the
    torch ops of the model's torch-op step around ``fast``: the stand-in
    for the kernel, which the CPU cannot run."""
    from piano_a2s_tpu_torch.models import score_transcription as tst
    from piano_a2s_tpu_torch.ops.note_step import step_mask

    def step(p, work, enc, enc_proj2, h2, tok2, lengths, done, t, caps,
             logp, pred, eos, live=None):
        m = step_mask(done, t, caps, work.groups, live)
        t += 1
        h_new, lp, a = fast(p, enc, enc_proj2, h2, tok2)
        h2.copy_(torch.where(m[..., None], h_new, h2))
        logp.copy_(torch.where(m[..., None], lp, 0.0))
        pred.copy_(torch.where(m, a, 0))
        is_eos = (a == eos) & m
        lengths.copy_(torch.where(is_eos, t, lengths))
        done.copy_(done | is_eos)
        tok2.copy_(torch.where(m[..., None], tst._tok_proj(p, a), tok2))

    return step


def _tiny_decode(case):
    """Weights, operands and a decode state of the tiny model at the start
    of a bar, in stop groups of 2 rows: ``case`` "decoding" or "to_eos"
    (the upper staff's best token is the one before <eos>, so the altered
    one stops the row)."""
    import types

    from piano_a2s_tpu_torch.models import score_transcription as tst
    from bench_port.tests.tiny import TINY_MODEL

    cfg = tst.ModelConfig(**dict(
        TINY_MODEL, max_length=tuple(TINY_MODEL["max_length"])))
    torch.manual_seed(3)
    up, low = tst.NoteDecoder(cfg), tst.NoteDecoder(cfg)
    B, T, D = 4, 9, 2 * cfg.hidden_size
    with torch.no_grad():
        for d in (up, low):
            for w in d.parameters():
                w.uniform_(-0.3, 0.3)
        if case == "to_eos":
            up.out.bias[cfg.eos - 1] += 50.0
        p = tst.dual_decode_params(up, low, cfg)
        enc = torch.tanh(torch.randn(B, T, D))
        ep2 = torch.stack([torch.nn.functional.linear(
            enc, d.attn.w_enc, d.attn.attn.bias) for d in (up, low)])
    st = tst._DecodeState(p, cfg, enc, 2).bind(p)
    sos = torch.full((2, B), cfg.sos, dtype=torch.long)
    st.reset(p, torch.tanh(torch.randn(B, D)), tst._tok_proj(p, sos))
    st.work = types.SimpleNamespace(groups=st.groups)
    return p, cfg, enc, ep2, st


def _steps(p, cfg, enc, ep2, st, n=3):
    """``n`` masked steps of the model (``_masked_step``): each step's
    tokens and log-probs, and the state after the last."""
    from piano_a2s_tpu_torch.models import score_transcription as tst

    out = []
    for _ in range(n):
        logp = torch.zeros(2, enc.shape[0], cfg.vocab_size)
        pred = torch.zeros(2, enc.shape[0], dtype=torch.long)
        tst._masked_step(p, cfg, enc, ep2, st, logp, pred)
        out.append((pred, logp))
    return out, {k: getattr(st, k).clone()
                 for k in ("h2", "tok2", "lengths", "done", "t")}


@pytest.mark.parametrize("case,steps", [("decoding", 3), ("to_eos", 3),
                                        ("decoding", 14)])
def test_the_altered_token_bites_on_the_k2_path(monkeypatch, case, steps):
    """On K2's path (``_masked_step`` calling ``note_step_cuda`` through
    its module, with a twin of the kernel in its place) the planted fault
    moves the upper staff's first token in the steps where that row
    decodes (not past the caps of 12 and 8 steps), and rewrites the row's
    projected token and stop from the moved one: every step gives what
    the fault gives on the torch-op path (the CPU's)."""
    from piano_a2s_tpu_torch.models import score_transcription as tst
    from piano_a2s_tpu_torch.ops import note_step_cuda as K2

    monkeypatch.setattr(K2, "note_step_cuda", _k2_twin(tst._fast_step))
    sound, _ = _steps(*_tiny_decode(case), steps)
    with planted("alter_served_token"):
        on_cpu = _steps(*_tiny_decode(case), steps)
        p, cfg, enc, ep2, st = _tiny_decode(case)
        monkeypatch.setattr(tst, "uses_k2", lambda enc: True)
        on_k2 = _steps(p, cfg, enc, ep2, st, steps)

    first, want = on_k2[0][0][0], sound[0][0].clone()
    want[0, 0] = (want[0, 0] + 1) % cfg.vocab_size
    assert torch.equal(first, want)
    for (pred_c, logp_c), (pred_k, logp_k) in zip(on_cpu[0], on_k2[0]):
        assert torch.equal(pred_c, pred_k)
        assert torch.equal(logp_c, logp_k)
    for k, v in on_cpu[1].items():
        assert torch.equal(v, on_k2[1][k]), k
    decoded = min(steps, cfg.max_length[0])
    assert not on_k2[0][-1][0].any() or decoded == steps
    # The row's next input: the last token it emitted.
    last = on_k2[0][decoded - 1][0]
    assert torch.equal(on_k2[1]["tok2"][0, 0], tst._tok_proj(p, last)[0, 0])
    assert bool(on_k2[1]["done"][0, 0]) == (case == "to_eos")


@pytest.mark.cuda
def test_the_altered_token_is_not_correct_on_the_card():
    """The offline cell on the card, briefly, with the served token altered
    (K2's step): its check fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    import json
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "bench_port/calibrate.py", "--workload",
         "serve_f32.offline_caps", "--seeds", "12345", "--seconds", "1",
         "--fault", "alter_served_token"],
        cwd=root, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    row = json.loads(out.stdout.strip().splitlines()[0])
    assert row["correct"] is False, row
    lim = json.load(open(os.path.join(
        root, "bench_port", "workloads", "serve_f32.offline_caps.json")))[
        "limits"]
    assert row["program"]["token_gap"] > lim["token_gap"], row


def test_a_returned_value_that_differs_from_the_decode_is_not_correct(
        monkeypatch):
    from piano_a2s_tpu_torch.infer import Transcriber
    inner = Transcriber.transcribe_batch

    def transcribe_batch(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        out[0][0][0] += 1               # the first clip's first key
        return out

    monkeypatch.setattr(Transcriber, "transcribe_batch", transcribe_batch)
    run = serve_run()
    assert run.checks["returned_mismatch"]["value"] == len(run.units)
    assert not run.correct


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_trained",
                                   "alter_teacher_token", "reset_acc_delta",
                                   "late_alter_teacher_token"])
def test_a_training_fault_is_not_correct(fault):
    with planted(fault):
        assert not train_run().correct


def test_a_fault_that_starts_in_the_window_passes_the_anchor_steps():
    # Only the judged window step can see it.
    with planted("late_alter_teacher_token"):
        run = train_run()
    anchors = ("loss1_gap", "grad_gap")
    assert all(run.checks[k]["ok"] for k in anchors), run.checks
    assert not run.correct


def test_a_non_finite_window_loss_is_not_correct(monkeypatch):
    from piano_a2s_tpu_torch.train import step as S
    inner, calls = S._forward, [0]

    def forward(*args, **kwargs):
        calls[0] += 1
        out = inner(*args, **kwargs)
        if calls[0] == 4:       # the window's first step, before the judged one
            out[2].data.fill_(float("nan"))
        return out

    monkeypatch.setattr(S, "_forward", forward)
    run = train_run()
    assert run.checks["window_nonfinite"]["value"] >= 1
    assert not run.correct


# -- what a run loads -------------------------------------------------------

def test_no_jax_after_a_run_of_each_entry():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from bench_port.tests.test_bench_port_check import serve_run, "
        "train_run\n"
        "serve_run(); train_run()\n"
        "from bench_port.harness.contract import forbidden_modules\n"
        "print('FORBIDDEN', forbidden_modules())\n"
        "print('LOADED', sorted(m for m in sys.modules "
        "if m.split('.')[0] == 'piano_a2s_tpu_torch')[:1])\n")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "LOADED ['piano_a2s_tpu_torch']" in out.stdout


def test_the_reference_imports_nothing_of_the_program():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("reference.py", "judge.py", "counts.py", "weights.py",
                 "traffic.py"):
        with open(os.path.join(here, "harness", name)) as f:
            text = f.read()
        assert "piano_a2s_tpu" not in text.replace("piano_a2s_tpu_torch",
                                                   "")
        assert "import piano_a2s_tpu_torch" not in text
        assert "from piano_a2s_tpu_torch" not in text
        assert "import jax" not in text


@pytest.mark.cuda
def test_each_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cells' kernels have no CPU "
                    "mode at these sizes)")
    import json
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for w in json.load(open(os.path.join(root, "BENCHMARK.json")))[
            "workloads"]:
        out = subprocess.run(
            [sys.executable, "bench_port/run.py", "--workload", w["name"],
             "--seed", "12345", "--seconds", "3", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

