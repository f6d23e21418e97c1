"""K3, the hand-written staff summaries (csrc/staff_summary.cu,
``ops/staff_summary_cuda.py``), and its plain twin
(``staff_summary_plain`` here).

On the CPU: the twin, K3's per-warp algorithm in torch ops (each lane's
three gate rows, the backward direction from length-1, the input half
computed one step ahead, no token read past a length), is held against the
packed GRU (``ops/gru.py::bidir_final_fused``) in float64 on ragged
lengths, on junk after each length, on the ``sos_token`` case and at the
offline cell's shape; tests/test_torch_layers.py holds it against the JAX
package's ``bidir_final_fused`` (a file with no test for the card). Also
the dispatch (``uses_k3``: a card, float32 weights, no gradient needed),
its counters and the wrapper's refusals.

On the card (marked cuda): K3 against the packed cuDNN call and both
against float64 (K3 within twice the packed float32 error, or 1e-6, about
8 float32 ulps of a hidden state near 1); K3 replayed in a CUDA graph with
new tokens and lengths; a traced greedy forward whose summaries K3
computes, one launch a call; a training forward that launches none.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import init_state_dict
from piano_a2s_tpu_torch.ops import gru as G
from piano_a2s_tpu_torch.ops import staff_summary_cuda as K3
from piano_a2s_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

EVERYTHING = (0, 2 ** 63)
# The offline cell's summaries: 2 staves x 16 clips, padded to the upper
# cap, at the caps' lengths.
CELL = (2, 16, 398)
CELL_LENGTHS = [[398] * 16, [189] * 16]
CPU_CFG = tst.ModelConfig(hidden_size=16, note_emb_size=8, staff_emb_size=8,
                          freq_bins=16, conv_feature_size=32, max_bars=2,
                          max_length=(10, 7))


# --- K3's plain twin ---------------------------------------------------------

def staff_summary_plain(gru, emb, tokens, lengths):
    """(S, B, 2H) as K3 computes it, in the weights' dtype: one warp per
    (sequence, direction), here all warps in lockstep. Lane j holds rows j,
    H + j, 2H + j of W_hh and W_ih (the gates r, z, n); a warp runs step i
    while i < its length, at position i forward and length-1-i backward,
    from h = 0; the input half of step i + 1 is computed during step i.
    A token is read only at a step below its sequence's length."""
    S, B, T = tokens.shape
    N, H, E = S * B, gru.hidden_size, gru.input_size
    toks = tokens.reshape(N, T)
    lens = lengths.reshape(N).to(toks.device).clamp(0, T)
    steps = int(lens.max()) if N else 0
    halves = []
    for suffix in ("", "_reverse"):
        w_ih = getattr(gru, f"weight_ih_l0{suffix}").reshape(3, H, E)
        w_hh = getattr(gru, f"weight_hh_l0{suffix}").reshape(3, H, H)
        b_ih = getattr(gru, f"bias_ih_l0{suffix}").reshape(3, H)
        b_hh = getattr(gru, f"bias_hh_l0{suffix}").reshape(3, H)
        backward = bool(suffix)

        def input_half(i):
            live = i < lens
            pos = (lens - 1 - i) if backward else torch.full_like(lens, i)
            pos = torch.where(live, pos, torch.zeros_like(pos))
            tok = toks.gather(1, pos[:, None])[:, 0]
            x = emb[torch.where(live, tok, torch.zeros_like(tok))]
            return torch.einsum("gje,ne->ngj", w_ih, x) + b_ih   # (N, 3, H)

        h = torch.zeros(N, H, dtype=w_hh.dtype)
        xp = input_half(0)
        for i in range(steps):
            xp_next = input_half(i + 1)
            hp = torch.einsum("gjk,nk->ngj", w_hh, h) + b_hh
            r = torch.sigmoid(xp[:, 0] + hp[:, 0])
            z = torch.sigmoid(xp[:, 1] + hp[:, 1])
            n = torch.tanh(xp[:, 2] + r * hp[:, 2])
            h = torch.where((i < lens)[:, None], (1 - z) * n + z * h, h)
            xp = xp_next
        halves.append(h)
    return torch.cat(halves, dim=-1).reshape(S, B, 2 * H)


def _decoder(cfg, seed=0, dtype=torch.float64):
    dec = tst.HierarchicalDecoder(cfg)
    sd = init_state_dict(cfg, seed)
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()
                         if k.startswith("decoder.")})
    return dec.to(dtype).eval()


def _tokens(shape, vocab, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).randint(0, vocab, shape)).long()


def _packed(dec, tokens, lengths):
    return G.bidir_final_fused(dec.staff_emb,
                               dec.note_emb.weight[tokens], lengths)


# --- on the CPU ----------------------------------------------------------------

RAGGED = [
    ((1, 3, 5), [[1, 5, 3]]),
    ((2, 4, 9), [[1, 9, 2, 9], [5, 1, 8, 3]]),
    ((4, 2, 7), [[7, 1], [2, 6], [1, 1], [7, 7]]),
]


@pytest.mark.parametrize("shape,lengths", RAGGED)
def test_the_twin_matches_the_packed_gru(shape, lengths):
    """Ragged lengths, 1 and T among them, in float64."""
    dec = _decoder(CPU_CFG)
    tokens = _tokens(shape, CPU_CFG.vocab_size, sum(shape))
    lengths = torch.tensor(lengths)
    with torch.no_grad():
        got = staff_summary_plain(dec.staff_emb, dec.note_emb.weight,
                                  tokens, lengths)
        want = _packed(dec, tokens, lengths)
    assert got.shape == (*shape[:2], 2 * CPU_CFG.staff_emb_size)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_junk_after_each_length_is_never_read():
    """Tokens past each length, even outside the vocabulary, change
    nothing, bit for bit."""
    dec = _decoder(CPU_CFG)
    tokens = _tokens((2, 4, 9), CPU_CFG.vocab_size, 1)
    lengths = torch.tensor([[1, 9, 4, 2], [9, 3, 1, 6]])
    junk = tokens.clone()
    for s in range(2):
        for b in range(4):
            junk[s, b, lengths[s, b]:] = 10 ** 6 if (s + b) % 2 else -3
    with torch.no_grad():
        clean = staff_summary_plain(dec.staff_emb, dec.note_emb.weight,
                                    tokens, lengths)
        dirty = staff_summary_plain(dec.staff_emb, dec.note_emb.weight,
                                    junk, lengths)
    assert torch.equal(clean, dirty)


def test_the_sos_token_case():
    """S = 1, length 2: [<sos>, <eos>] for every clip, as sos_token asks."""
    cfg = CPU_CFG
    dec = _decoder(cfg)
    tokens = torch.tensor([[[cfg.sos, cfg.eos]] * 3])
    lengths = torch.full((1, 3), 2)
    with torch.no_grad():
        got = staff_summary_plain(dec.staff_emb, dec.note_emb.weight,
                                  tokens, lengths)
        want = _packed(dec, tokens, lengths)
        token = dec.sos_token(3, torch.device("cpu"))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    h2 = 2 * cfg.staff_emb_size
    torch.testing.assert_close(token[:, :h2], got[0], rtol=0, atol=1e-12)
    torch.testing.assert_close(token[:, h2:2 * h2], got[0], rtol=0,
                               atol=1e-12)


def test_the_twin_at_the_cells_shape():
    """(2, 16, 398) at the paper's widths with lengths 398 and 189."""
    cfg = tst.ModelConfig()
    dec = _decoder(cfg)
    tokens = _tokens(CELL, cfg.vocab_size, 7)
    lengths = torch.tensor(CELL_LENGTHS)
    with torch.no_grad():
        got = staff_summary_plain(dec.staff_emb, dec.note_emb.weight,
                                  tokens, lengths)
        want = _packed(dec, tokens, lengths)
    assert got.shape == (2, 16, 2 * cfg.staff_emb_size)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def _card_like(dtype=torch.int64):
    return types.SimpleNamespace(is_cuda=True, dtype=dtype)


def test_uses_k3_follows_device_dtype_and_gradients():
    dec = _decoder(CPU_CFG, dtype=torch.float32)
    mods = (dec.note_emb, dec.staff_emb)
    tokens = torch.zeros(1, 2, 3, dtype=torch.long)
    with torch.no_grad():
        assert tst.uses_k3(_card_like(), *mods)
        assert not tst.uses_k3(tokens, *mods)            # the CPU
    # Gradients on and weights that require them: the packed path.
    assert not tst.uses_k3(_card_like(), *mods)
    with torch.inference_mode():
        assert tst.uses_k3(_card_like(), *mods)
    dec.requires_grad_(False)
    assert tst.uses_k3(_card_like(), *mods)
    with torch.no_grad():
        assert not tst.uses_k3(_card_like(), *(m.double() for m in mods))


def _counts(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("forward/decoder", ranged=False):
            out = fn()
    span, = [r for r in P.records(*EVERYTHING)
             if r.name == "forward/decoder"]
    P.RECORDER.clear()
    return out, span.counts


def test_staff_summaries_dispatch_and_count(monkeypatch):
    """The CPU, and gradients on, take the packed path and count no kernel
    rows; where uses_k3 holds, K3's wrapper answers, with the lengths on
    the tokens' device, and every row counts as the kernel's."""
    P.RECORDER.clear()
    dec = _decoder(CPU_CFG, dtype=torch.float32)
    tokens = _tokens((2, 3, 6), CPU_CFG.vocab_size, 2)
    lengths = torch.tensor([[1, 6, 3], [2, 5, 6]])
    with torch.no_grad():
        want = _packed(dec, tokens, lengths)
        out, counts = _counts(lambda: dec.staff_summaries(tokens, lengths))
    assert torch.equal(out, want)
    assert counts == {"summary_rows": 6, "summary_kernel_rows": 0}
    out, counts = _counts(lambda: dec.staff_summaries(tokens, lengths))
    assert out.requires_grad
    assert counts == {"summary_rows": 6, "summary_kernel_rows": 0}

    calls = []

    def stand_in(gru, emb, toks, lens):
        calls.append(lens.device == toks.device)
        return staff_summary_plain(gru, emb, toks, lens)

    monkeypatch.setattr(tst, "uses_k3", lambda *a: True)
    monkeypatch.setattr(K3, "staff_summary_cuda", stand_in)
    with torch.no_grad():
        out, counts = _counts(lambda: dec.staff_summaries(tokens, lengths))
    assert calls == [True]
    torch.testing.assert_close(out, want, rtol=0, atol=2e-6)
    assert counts == {"summary_rows": 6, "summary_kernel_rows": 6}


def test_a_training_forward_counts_no_kernel_rows(monkeypatch):
    """The teacher-forced forward with gradients: every summary packed,
    K3's wrapper never called, even with a card's tokens assumed."""
    from piano_a2s_tpu_torch.train.synthetic import random_targets

    def refuse(*a, **k):
        raise AssertionError("K3 launched")

    monkeypatch.setattr(K3, "staff_summary_cuda", refuse)
    real = tst.uses_k3
    monkeypatch.setattr(tst, "uses_k3",
                        lambda t, *m: real(_card_like(), *m))
    cfg = CPU_CFG
    model = tst.ScoreTranscription(cfg)
    model.load_state_dict(init_state_dict(cfg, 0))
    batch = random_targets(cfg, 2, seed=1)
    gt = tuple(torch.as_tensor(batch[k]) for k in (
        "time_sig", "key", "upper", "upper_lengths", "lower",
        "lower_lengths"))
    spec = torch.randn(2, 1, 20, cfg.freq_bins)
    P.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = model(spec, train=True, ground_truth=gt, tf_ratio=0.5,
                    generator=torch.Generator().manual_seed(0))
    recs = P.records(*EVERYTHING)
    P.RECORDER.clear()
    assert all(torch.isfinite(x).all() for x in out[:4])
    decoder, = [r for r in recs if r.name == "forward/decoder"]
    # sos_token's B rows, then four staves of B a bar.
    assert decoder.counts["summary_rows"] == 2 + cfg.max_bars * 4 * 2
    assert decoder.counts["summary_kernel_rows"] == 0


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA"), ("float64", TypeError, "float32"),
    ("int32", TypeError, "int64"), ("strided", ValueError, "contiguous"),
    ("hidden_48", ValueError, "hidden size of at most 32"),
    ("input_80", ValueError, "input size of at most 64"),
    ("unidirectional", ValueError, "bidirectional")])
def test_the_wrapper_raises_on_what_it_does_not_take(monkeypatch, case,
                                                     error, match):
    """No fallback: each refusal comes before the library is loaded."""
    monkeypatch.setattr(K3, "_library", None)
    E, H = {"hidden_48": (16, 48), "input_80": (80, 32)}.get(case, (16, 32))
    gru = torch.nn.GRU(E, H, bidirectional=case != "unidirectional",
                       batch_first=True)
    emb = torch.randn(10, E)
    tokens = torch.zeros(2, 3, 5, dtype=torch.long)
    lengths = torch.ones(2, 3, dtype=torch.long)
    if case == "float64":
        gru, emb = gru.double(), emb.double()
    elif case == "int32":
        lengths = lengths.int()
    elif case == "strided":
        tokens = torch.zeros(2, 5, 3, dtype=torch.long).transpose(1, 2)
    # The module's, dtypes', shapes' and layouts' checks come before the
    # devices', so CPU operands show each refusal.
    with pytest.raises(error, match=match):
        K3.staff_summary_cuda(gru, emb, tokens, lengths)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 has no CPU mode)")
    return torch.device("cuda")


def _card_decoder(card, seed=0):
    cfg = tst.ModelConfig()
    dec = _decoder(cfg, seed, torch.float32).to(card)
    return cfg, dec, _decoder(cfg, seed, torch.float64).to(card)


def _three_ways(dec, dec64, tokens, lengths):
    """(K3, packed float32, packed float64) summaries on the card."""
    with torch.no_grad():
        k3 = K3.staff_summary_cuda(dec.staff_emb, dec.note_emb.weight,
                                   tokens, lengths)
        plain = _packed(dec, tokens, lengths)
        ref = _packed(dec64, tokens, lengths)
    torch.cuda.synchronize()
    return k3.double(), plain.double(), ref


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seed", [(CELL, None), ((2, 16, 398), 1),
                                        ((4, 5, 37), 2), ((1, 16, 2), 3)])
def test_k3_matches_the_packed_call_on_the_card(card, shape, seed):
    cfg, dec, dec64 = _card_decoder(card)
    tokens = _tokens(shape, cfg.vocab_size, sum(shape)).to(card)
    if seed is None:
        lengths = torch.tensor(CELL_LENGTHS, device=card)
    else:
        lengths = torch.from_numpy(np.random.RandomState(seed).randint(
            1, shape[2] + 1, shape[:2])).to(card)
        lengths.view(-1)[0] = 1
        lengths.view(-1)[-1] = shape[2]
    k3, plain, ref = _three_ways(dec, dec64, tokens, lengths)
    err = (k3 - ref).abs().max().item()
    plain_err = (plain - ref).abs().max().item()
    print(f"{shape}: K3 against float64 {err:.3e}, packed float32 "
          f"{plain_err:.3e}, |K3 - packed| "
          f"{(k3 - plain).abs().max().item():.3e}")
    assert err <= max(2 * plain_err, 1e-6)


@pytest.mark.cuda
def test_k3_replays_in_a_cuda_graph(card):
    """Captured once; tokens and lengths changed in place between
    replays; each replay equal to an uncaptured call, which is
    deterministic. The capture counts no launch."""
    cfg, dec, _ = _card_decoder(card)
    tokens = torch.zeros(CELL, dtype=torch.long, device=card)
    lengths = torch.ones(CELL[:2], dtype=torch.long, device=card)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.no_grad(), torch.cuda.stream(side):
        K3.staff_summary_cuda(dec.staff_emb, dec.note_emb.weight, tokens,
                              lengths)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = K3.staff_summary_cuda.launches
    with torch.no_grad(), torch.cuda.graph(graph, stream=side):
        out = K3.staff_summary_cuda(dec.staff_emb, dec.note_emb.weight,
                                    tokens, lengths)
    assert K3.staff_summary_cuda.launches == before
    rng = np.random.RandomState(4)
    for _ in range(3):
        tokens.copy_(_tokens(CELL, cfg.vocab_size, rng.randint(1000)))
        lengths.copy_(torch.from_numpy(rng.randint(1, CELL[2] + 1,
                                                   CELL[:2])))
        graph.replay()
        with torch.no_grad():
            want = K3.staff_summary_cuda(dec.staff_emb, dec.note_emb.weight,
                                         tokens, lengths)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_the_wrapper_raises_on_a_width_on_the_card(card):
    gru = torch.nn.GRU(16, 48, bidirectional=True, batch_first=True).to(card)
    with pytest.raises(ValueError, match="hidden size of at most 32"):
        K3.staff_summary_cuda(gru, torch.randn(10, 16, device=card),
                              torch.zeros(1, 2, 3, dtype=torch.long,
                                          device=card),
                              torch.ones(1, 2, dtype=torch.long,
                                         device=card))


@pytest.mark.cuda
def test_a_traced_greedy_forward_runs_every_summary_on_k3(card):
    """The paper's widths, 2 bars: sos_token's call and one a bar, each
    one launch, every row counted as K3's."""
    cfg = tst.ModelConfig(max_bars=2, max_length=(40, 24))
    model = tst.ScoreTranscription(cfg)
    model.load_state_dict(init_state_dict(cfg, 0))
    model = model.to(card).eval()
    spec = torch.randn(4, 1, 120, cfg.freq_bins, device=card)
    with torch.inference_mode():
        model(spec)                                   # the capture
        P.RECORDER.clear()
        K3.staff_summary_cuda.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            model(spec)
    recs = P.records(*EVERYTHING)
    P.RECORDER.clear()
    decoder, = [r for r in recs if r.name == "forward/decoder"]
    assert decoder.counts["summary_rows"] == 4 + cfg.max_bars * 2 * 4
    assert decoder.counts["summary_kernel_rows"] == \
        decoder.counts["summary_rows"]
    assert K3.staff_summary_cuda.launches == 1 + cfg.max_bars


@pytest.mark.cuda
def test_a_training_forward_launches_no_k3(card):
    from piano_a2s_tpu_torch.train.synthetic import random_targets

    cfg = tst.ModelConfig(max_bars=2, max_length=(40, 24))
    model = tst.ScoreTranscription(cfg)
    model.load_state_dict(init_state_dict(cfg, 0))
    model = model.to(card).train()
    batch = random_targets(cfg, 2, seed=1)
    gt = tuple(torch.as_tensor(batch[k], device=card) for k in (
        "time_sig", "key", "upper", "upper_lengths", "lower",
        "lower_lengths"))
    K3.staff_summary_cuda.launches = 0
    out = model(torch.randn(2, 1, 120, cfg.freq_bins, device=card),
                train=True, ground_truth=gt, tf_ratio=0.5,
                generator=torch.Generator(card).manual_seed(0))
    sum(x.float().sum() for x in out[:4]).backward()
    torch.cuda.synchronize()
    assert K3.staff_summary_cuda.launches == 0
