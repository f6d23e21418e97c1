"""The teacher-forced bar with gradients (``_TeacherBar``) against a plain
unrolled autograd loop of ``_teacher_step``.

``_TeacherBar`` runs a bar's steps without autograd, keeps each step's
input state, and in its backward recomputes and differentiates the steps
one at a time from the last (``_teacher_sweep``). On a card both halves
replay CUDA graphs (``_TeacherGraph``) whose bodies are plain torch, so
the CPU runs the code the card replays, uncaptured. The reference is the
loop autograd differentiates as it runs, with no checkpoint and no node
of our own (``unrolled_bar``).

Tolerances, in float64: the bar's outputs are computed by the same ops on
the same values, so they must be equal; so must the gradients of one bar,
whose parts the sweep sums in the order autograd's engine sums them (step
T-1 first). A whole step's gradients may differ in the last bits only:
the sweep sums a bar's 64 parts of a leaf shared by the bars (enc, the
weights) before autograd adds the bars together, where the unrolled loop
adds every part into one buffer. Each leaf's gradient must be within
1e-12 of its largest entry, about 4500 float64 ulps, far below any
algebraic fault (a dropped or doubled step moves a leaf by its whole
part) and above the reordering of a few hundred sums (3.5e-15 at most
over these cases). bf16 runs at the bar level only, where the orders
agree; its gradients must then be equal.

The card's own tests are marked cuda: captured against uncaptured, a
second call with other weights, and five bars of one step through one
graph pair.
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import init_state_dict
from piano_a2s_tpu_torch.train import losses as tlosses
from piano_a2s_tpu_torch.train import step as tstep

torch.set_num_threads(2)

CFG = tst.ModelConfig(freq_bins=24, conv_feature_size=32, hidden_size=24,
                      max_bars=2, max_length=(10, 7), note_emb_size=8,
                      staff_emb_size=8)
T_SPEC = 30
# Of the largest entry of each leaf's gradient (see the module docstring).
REL_STEP = 1e-12


def unrolled_bar(graph, emit_full, sos, enc, enc_proj2, h0, gt2, drops,
                 coins, guides, *weights):
    """The bar as a plain loop of ``_teacher_step`` that autograd records
    as it runs: ``_TeacherBar.apply``'s signature and outputs."""
    B, T = gt2.shape[1], gt2.shape[2]
    h2 = torch.stack([h0, h0])
    tok2 = tst._embed2(weights[0], torch.full((2, B), sos, dtype=torch.long,
                                              device=gt2.device))
    ga = torch.zeros((2, B), dtype=torch.float32, device=gt2.device)
    emitted, preds = [], []
    for t in range(T):
        h2, tok2, e, pred, pen = tst._teacher_step(
            emit_full, enc, enc_proj2, h2, tok2,
            None if drops is None else drops[t], gt2[:, :, t],
            None if guides is None else guides[t], coins[t], *weights)
        if pen is not None:
            ga = ga + pen
        emitted.append(e)
        preds.append(pred)
    return torch.stack(emitted), torch.stack(preds), ga


@dataclasses.dataclass(frozen=True)
class Case:
    emit_full: bool = False
    guides: bool = False
    widths: tuple = (7, 7)            # (T_up, T_low)
    b: int = 3
    bf16: bool = False
    rows: tuple = None                # a data-parallel rank's (start, total)


CASES = {
    "fused": Case(),
    "full": Case(emit_full=True),
    "guides": Case(guides=True),
    "widths": Case(widths=(10, 5)),
    "b1": Case(b=1),
    "bf16": Case(bf16=True),
    "dp_rows": Case(rows=(2, 7)),
}


def _model(seed=3, dtype=torch.float64):
    model = tst.ScoreTranscription(CFG).to(dtype)
    model.load_state_dict(init_state_dict(CFG, seed, dtype))
    return model


def _batch(b, widths, seed=5, cfg=CFG):
    """Spectrogram and well-formed targets cut to ``widths``: each staff's
    tokens, then EOS, then <pad>; lengths exclude the EOS."""
    rng = np.random.RandomState(seed)
    bars = cfg.max_bars

    def staff(cap):
        tok = np.full((b, bars, cap), cfg.pad, np.int64)
        lens = np.zeros((b, bars), np.int64)
        for i in range(b):
            for m in range(bars):
                n = rng.randint(1, cap - 1)
                tok[i, m, :n] = rng.choice(140, n)
                tok[i, m, n] = cfg.eos
                lens[i, m] = n
        return tok, lens

    up, up_len = staff(widths[0])
    low, low_len = staff(widths[1])
    return {"spectrogram": torch.from_numpy(
                rng.randn(b, 1, T_SPEC, cfg.freq_bins)),
            "time_sig": torch.from_numpy(
                rng.randint(0, cfg.num_time_sig, (b, bars))),
            "key": torch.from_numpy(rng.randint(0, cfg.num_keys, (b, bars))),
            "upper": torch.from_numpy(up),
            "upper_lengths": torch.from_numpy(up_len),
            "lower": torch.from_numpy(low),
            "lower_lengths": torch.from_numpy(low_len),
            "ga_content": torch.from_numpy(
                rng.uniform(0.5, 1.0, b).astype(np.float32))}


class Bar:
    """A bar's leaves (enc, enc_proj2, h0, on the model's device, and the
    note decoders' parameters) and ``note_decoder_dual_scan``'s arguments
    in the case's dtype, made anew for each call (``run``) from the same
    values: the staves' stacked weights and a generator seeded alike."""

    def __init__(self, case: Case, model, seed=7):
        g = torch.Generator().manual_seed(seed)
        dev = next(model.parameters()).device
        dtype = torch.bfloat16 if case.bf16 else torch.float64
        h, b = CFG.hidden_size, case.b

        def leaf(*shape):
            return torch.randn(shape, generator=g, dtype=torch.float64).to(
                dev, dtype).requires_grad_()

        self.case, self.model, self.seed = case, model, seed
        self.enc, self.enc_proj2, self.h0 = (
            leaf(b, 12, 2 * h), leaf(2, b, 12, h), leaf(b, 2 * h))
        batch = {k: v.to(dev) for k, v in _batch(b, case.widths, seed).items()}
        self.gt = (batch["upper"][:, 0], batch["lower"][:, 0],
                   torch.stack([batch["upper_lengths"][:, 0],
                                batch["lower_lengths"][:, 0]]) + 1)
        self.kw = dict(tf_ratio=0.5, train=True, emit_full=case.emit_full)
        if case.guides:
            self.kw.update(ga_frac=(0.2, 0.5),
                           ga_content=batch["ga_content"])
        if case.rows:
            self.kw.update(group=object(), rows=case.rows)
        dec = model.decoder
        self.leaves = [self.enc, self.enc_proj2, self.h0] + [
            p for d in (dec.upper_decoder, dec.lower_decoder)
            for p in d.parameters()]

    def run(self, graphs=None):
        """The bar's outputs, and the gradients of its leaves under a
        random weighting of its emitted log-probs and penalty."""
        dec, dev = self.model.decoder, self.enc.device
        weights = tst._stack_staves(dec.upper_decoder, dec.lower_decoder,
                                    torch.bfloat16 if self.case.bf16
                                    else None)
        gen = torch.Generator(dev).manual_seed(self.seed)
        (up_lp, up_tok), (low_lp, low_tok), ga = tst.note_decoder_dual_scan(
            weights, CFG, self.enc, self.enc_proj2, self.h0, *self.gt,
            generator=gen, graphs=graphs, **self.kw)
        outs = [up_lp, up_tok, low_lp, low_tok] + ([] if ga is None
                                                  else [ga])
        if not torch.is_grad_enabled():
            return outs, None
        g = torch.Generator().manual_seed(11)
        loss = sum((x.double() * torch.randn(
            x.shape, generator=g, dtype=torch.float64).to(dev)).sum()
            for x in (up_lp, low_lp) + (() if ga is None else (ga,)))
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        # The attention's key projection makes enc_proj2, not the bar.
        return [x.detach() for x in outs], [
            torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, self.leaves)]


def _whole_step(case: Case, model, batch):
    """The loss and each parameter's gradient of one training step: a
    ``train_step`` where it takes the case's options (its gradients read
    before the clip and the update), else the training forward, the loss
    and the backward with them."""
    gen = torch.Generator(batch["spectrogram"].device).manual_seed(13)
    if case.emit_full or case.bf16:
        outs = model(batch["spectrogram"], train=True, ground_truth=(
            batch["time_sig"], batch["key"], batch["upper"],
            batch["upper_lengths"], batch["lower"], batch["lower_lengths"]),
            tf_ratio=0.5, emit_full=case.emit_full, generator=gen,
            decode_dtype=torch.bfloat16 if case.bf16 else None)
        lossfn = (tlosses.transcription_loss if case.emit_full
                  else tlosses.transcription_loss_fused)
        loss = lossfn(outs, batch, CFG.pad)[0]
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone()
                             for n, p in model.named_parameters()}
    seen = {}
    update = tstep._clip_and_update

    def spy(model, *a, **k):
        seen.update({n: (torch.zeros_like(p) if p.grad is None
                         else p.grad.clone())
                     for n, p in model.named_parameters()})
        return update(model, *a, **k)

    ga = dict(ga_weight=1.0, ga_sigma=0.15) if case.guides else {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tstep, "_clip_and_update", spy)
        out = tstep.train_step(model, tstep.make_optimizer(
            model.parameters()), batch, gen, 0.5, **ga)
    return float(out.loss), seen


def _assert_outputs(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _assert_grads(got, want, rel):
    for name, g in (got.items() if isinstance(got, dict)
                    else enumerate(got)):
        w = want[name]
        scale = float(w.abs().max())
        err = float((g.double() - w.double()).abs().max())
        assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_teacher_bar_matches_the_unrolled_loop(monkeypatch, name):
    case = CASES[name]
    model = _model(dtype=torch.float32 if case.bf16 else torch.float64)
    bar = Bar(case, model)
    got = bar.run()
    with monkeypatch.context() as m:
        m.setattr(tst._TeacherBar, "apply", unrolled_bar)
        want = bar.run()
    _assert_outputs(got[0], want[0])
    _assert_grads(got[1], want[1], 0.0)

    if case.rows or case.bf16:
        return  # a bar only: see the module docstring and Case
    batch = _batch(case.b, case.widths)
    loss, grads = _whole_step(case, copy.deepcopy(model), batch)
    with monkeypatch.context() as m:
        m.setattr(tst._TeacherBar, "apply", unrolled_bar)
        loss_ref, grads_ref = _whole_step(case, copy.deepcopy(model), batch)
    assert loss == loss_ref
    assert set(grads) == set(grads_ref)
    _assert_grads(grads, grads_ref, REL_STEP)


def test_no_grad_runs_the_plain_loop(monkeypatch):
    """Without gradients the bar is no autograd node: the plain loop gives
    the Function's outputs, and ``_TeacherBar`` is not called."""
    bar = Bar(CASES["guides"], _model())
    want = bar.run()[0]
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(tst._TeacherBar, "apply", None)
        got = bar.run()[0]
    _assert_outputs(got, want)


def test_the_bar_counts_its_steps():
    """Under the profiler each bar's forward counts its steps on the
    decoder's span and its backward sweep on the backward's (on the CPU
    autograd runs it on the calling thread); no step is a replay here."""
    from torch.profiler import ProfilerActivity, profile

    from piano_a2s_tpu_torch.utils import profiling as P

    case = CASES["widths"]
    P.RECORDER.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            _whole_step(case, _model(), _batch(case.b, case.widths))
        recs = P.records(0, 2 ** 63)
    finally:
        P.RECORDER.clear()
    steps = CFG.max_bars * max(case.widths)
    decoder, = [r for r in recs if r.name == "forward/decoder"]
    backward, = [r for r in recs if r.name == "train_step/backward"]
    assert decoder.counts["teacher_steps"] == steps
    assert backward.counts["teacher_steps"] == steps
    assert not any("teacher_graph_steps" in r.counts for r in recs
                   if isinstance(r, P.Span))


def test_the_graph_path_is_taken_on_a_card_with_grad():
    """The rule the bar follows, on stand-ins for a card's tensors: a
    call with gradients on a card replays graphs (a data-parallel group
    too: the bar runs no collective); without gradients, or on the CPU,
    it does not."""
    card = types.SimpleNamespace(is_cuda=True)
    with torch.enable_grad():
        assert tst.teacher_runs_as_graph(card)
        assert not tst.teacher_runs_as_graph(torch.zeros(1))
    with torch.no_grad():
        assert not tst.teacher_runs_as_graph(card)


def test_a_copy_of_the_decoder_keeps_no_teacher_graph():
    import pickle

    dec = _model().decoder
    dec._teacher_graphs._by_shape["shape"] = object()
    for other in (copy.deepcopy(dec), pickle.loads(pickle.dumps(dec))):
        assert other._teacher_graphs._by_shape == {}
    assert dec._teacher_graphs._by_shape


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused", "full", "guides", "widths",
                                  "bf16", "dp_rows"])
def test_captured_bar_equals_uncaptured_on_the_card(card, name):
    """The graph pair's outputs and gradients against the same Function
    run eagerly on the card; then, with other weights and other inputs,
    a second call of the same shape (a replay) against the eager one."""
    case = CASES[name]
    model = _model(dtype=torch.float32 if case.bf16 else torch.float64
                   ).to(card)
    graphs = tst._TeacherGraphs()
    for seed in (7, 8):
        if seed == 8:
            with torch.no_grad():
                for p in model.decoder.parameters():
                    p.mul_(1.1)
        bar = Bar(case, model, seed)
        got, want = bar.run(graphs), bar.run()
        assert len(graphs._by_shape) == 1
        _assert_outputs(got[0], want[0])
        _assert_grads(got[1], want[1], 0.0)


@pytest.mark.cuda
def test_five_bars_of_a_step_replay_one_graph_pair(card):
    """Two training steps of five bars each through one captured pair
    (captured in the first, replayed with updated weights in the second):
    each step's loss and every parameter's gradient as the eager Function
    gives them on the card, so each bar's gradients are its own and not
    those of the pair's last replay."""
    cfg = dataclasses.replace(CFG, max_bars=5)
    model = tst.ScoreTranscription(cfg).double()
    model.load_state_dict(init_state_dict(cfg, 3, torch.float64))
    runs = {}
    for graphs_on in (True, False):
        m = copy.deepcopy(model).to(card)
        steps = []
        with pytest.MonkeyPatch.context() as mp:
            if not graphs_on:
                mp.setattr(tst, "teacher_runs_as_graph", lambda enc: False)
            for seed in (5, 6):
                batch = {k: v.to(card) for k, v in
                         _batch(3, (10, 7), seed, cfg).items()}
                steps.append(_whole_step(Case(), m, batch))
        assert len(m.decoder._teacher_graphs._by_shape) == int(graphs_on)
        runs[graphs_on] = steps
    for (loss, grads), (loss_ref, grads_ref) in zip(runs[True], runs[False]):
        assert abs(loss - loss_ref) <= REL_STEP * abs(loss_ref)
        _assert_grads(grads, grads_ref, REL_STEP)
