"""Faults planted in the timed path, to show that the check catches them
(bench_port/tests and ``calibrate.py --fault``). Each is a list of
(object, attribute, replacement) patches made while its ``planted``
context is open."""

from __future__ import annotations

import contextlib


def _alter_served_token():
    """The greedy step's first row of the upper staff emits the next id
    over from its best token, in every step where that row decodes, and
    the next step conditions on it. Planted in both steps of the port: the
    torch-op step's ``_fast_step`` (the CPU, bf16, float64), and after
    K2's ``note_step_cuda`` (a card's float32 step, which picks its token
    on the card), where the row's token, its projection ``tok2`` and its
    stop are rewritten as the torch-op step would have made them from the
    altered token. Both are looked up on their module at every step, so a
    graph captured while the fault is planted holds it."""
    import torch
    from piano_a2s_tpu_torch.models import score_transcription as st
    from piano_a2s_tpu_torch.ops import note_step_cuda as K2
    from piano_a2s_tpu_torch.ops.note_step import step_mask
    inner, k2 = st._fast_step, K2.note_step_cuda

    def step(*args):
        h, logp, pred = inner(*args)
        pred = pred.clone()
        pred[0, 0] = (pred[0, 0] + 1) % logp.shape[-1]
        return h, logp, pred

    class K2Step:
        """K2's step, then the fault; its launch count is K2's own."""
        launches = property(lambda self: k2.launches,
                            lambda self, n: setattr(k2, "launches", n))

        def __call__(self, p, work, enc, enc_proj2, h2, tok2, lengths, done,
                     t, caps, logp, pred, eos, live=None):
            # The row's mask as the torch-op step makes it, and its stop
            # before the step.
            m = step_mask(done, t, caps, work.groups, live)[0, 0]
            was_done, was_len = done[0, 0].clone(), lengths[0, 0].clone()
            k2(p, work, enc, enc_proj2, h2, tok2, lengths, done, t, caps,
               logp, pred, eos, live)
            tok = torch.where(m, (pred[0, 0] + 1) % logp.shape[-1],
                              pred[0, 0])
            pred[0, 0] = tok
            is_eos = m & (tok == eos)
            done[0, 0] = was_done | is_eos
            lengths[0, 0] = torch.where(is_eos, t, was_len)
            tok2[0, 0] = torch.where(m, st._tok_proj(p, pred)[0, 0],
                                     tok2[0, 0])

    return [(st, "_fast_step", step), (K2, "note_step_cuda", K2Step())]


def _half_batch_served():
    """The greedy forward decodes the first half of the batch and returns
    its outputs twice."""
    import torch
    from piano_a2s_tpu_torch.models.score_transcription import (
        ScoreTranscription)
    inner = ScoreTranscription._greedy

    def greedy(self, spec, *args):
        half = max(1, spec.shape[0] // 2)
        ts, key, up, low, aux = inner(self, spec[:half], *args)

        def twice(x):
            return torch.cat([x, x])[:spec.shape[0]]

        return (twice(ts), twice(key), twice(up), twice(low),
                {k: twice(v) for k, v in aux.items()})

    return [(ScoreTranscription, "_greedy", greedy)]


def _state_unchanged():
    """The optimizer's step leaves the parameters as they were."""
    import torch
    return [(torch.optim.Adadelta, "step", lambda self, closure=None: None)]


def _half_batch_trained():
    """The training forward runs the first half of the batch and the loss
    is the mean over those rows (their outputs given twice)."""
    import torch
    from piano_a2s_tpu_torch.train import step as S
    inner = S._forward

    def forward(model, batch, *args, **kwargs):
        half = batch["time_sig"].shape[0] // 2
        ts, key, up, low, aux = inner(
            model, {k: v[:half] for k, v in batch.items()}, *args, **kwargs)
        return (torch.cat([ts, ts]), torch.cat([key, key]),
                torch.cat([up, up]), torch.cat([low, low]), aux)

    return [(S, "_forward", forward)]


def _alter_teacher_token():
    """The teacher-forced step hands on its next token's embedding scaled
    by 1.5."""
    from piano_a2s_tpu_torch.models import score_transcription as st
    inner = st._teacher_step

    def step(*args):
        h, tok, emitted, pred, pen = inner(*args)
        return h, tok * 1.5, emitted, pred, pen

    return [(st, "_teacher_step", step)]


def _reset_acc_delta():
    """Adadelta forgets its running mean of squared updates before every
    step, so that each update is scaled as a first step's."""
    import torch
    inner = torch.optim.Adadelta.step

    def step(self, closure=None):
        for state in self.state.values():
            if "acc_delta" in state:
                state["acc_delta"].zero_()
        return inner(self, closure)

    return [(torch.optim.Adadelta, "step", step)]


def _late_alter_teacher_token():
    """From the fourth training step on (past set-up's three), the
    teacher-forced step hands on its next token's embedding scaled by 1.5:
    a path that only starts once the step is warm."""
    from piano_a2s_tpu_torch.models import score_transcription as st
    from piano_a2s_tpu_torch.train import step as S
    calls = [0]
    forward, inner = S._forward, st._teacher_step

    def counted(*args, **kwargs):
        calls[0] += 1
        return forward(*args, **kwargs)

    def step(*args):
        h, tok, emitted, pred, pen = inner(*args)
        return h, (tok * 1.5 if calls[0] > 3 else tok), emitted, pred, pen

    return [(S, "_forward", counted), (st, "_teacher_step", step)]


FAULTS = {
    "alter_served_token": _alter_served_token,
    "half_batch_served": _half_batch_served,
    "state_unchanged": _state_unchanged,
    "half_batch_trained": _half_batch_trained,
    "alter_teacher_token": _alter_teacher_token,
    "reset_acc_delta": _reset_acc_delta,
    "late_alter_teacher_token": _late_alter_teacher_token,
}


@contextlib.contextmanager
def planted(name: str):
    patches = FAULTS[name]()
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, new in patches:
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in saved:
            setattr(obj, attr, old)
