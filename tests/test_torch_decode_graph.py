"""The greedy note decode's one loop (``_NoteDecode``): blocks of K steps
against single steps.

On a card the loop replays a CUDA graph of K steps; its body is plain
torch, so the CPU runs the same blocks without capturing them, and holds
them against the loop the CPU itself runs, uncaptured single steps (K = 1;
``test_torch_model.py``, ``test_torch_decode_chunk.py`` and
``test_torch_parallel.py`` hold that against the JAX package). The bars
here are the real bars of a weak model's greedy forward (the note
decodes' operands taken from each bar of the forward), so the stop groups
stop where that model stops them. Tokens, lengths and log-probs must be
exactly equal, and the counters those of single steps (the steps rounded
up to whole blocks). The card's own test is
``test_graph_path_matches_the_eager_loop_on_the_card`` (marked cuda),
captured blocks against uncaptured single steps there.
"""

import contextlib
import math
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import init_state_dict
from piano_a2s_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

# tests/test_torch_tracing.py's weak model: with EOS_BIAS its stop groups
# of 16 on _spec's 32 clips stop at upper (1, 1), lower (6, 6) in the first
# bar and upper (2, 3), lower (1, 2) in the second.
CFG = tst.ModelConfig(freq_bins=16, conv_feature_size=32, hidden_size=16,
                      max_bars=2, max_length=(8, 6), note_emb_size=8,
                      staff_emb_size=8)
SEED, EOS_BIAS, CONV_SCALE, CHUNK = 1, 0.6, 3.0, 16
MIXED = [[[1, 1], [6, 6]], [[2, 3], [1, 2]]]
EVERYTHING = (0, 2 ** 63)


def _weak_model(eos_bias):
    model = tst.ScoreTranscription(CFG)
    model.load_state_dict(init_state_dict(CFG, SEED))
    model.eval()
    with torch.no_grad():
        for d in (model.decoder.upper_decoder, model.decoder.lower_decoder):
            d.out.bias[CFG.eos] += eos_bias
        for p in model.convstack.parameters():
            p.mul_(CONV_SCALE)
    return model


def _spec(b, seed=0):
    rng = np.random.RandomState(seed)
    scale = rng.choice([0.0, 1, 3, 10, 30, 100], (b, 1, 1, 1))
    return torch.from_numpy((rng.randn(b, 1, 20, 16) * scale)
                            .astype(np.float32))


def _bars(monkeypatch, eos_bias, b, dtype):
    """The note decodes of a greedy forward, a bar each: ((operands, h0,
    group, stop group size, K), outputs). A CPU forward captures nothing:
    it runs uncaptured single steps."""
    calls = []
    decode = tst._NoteDecode.decode

    def spy(self, h0):
        out = decode(self, h0)
        g = self.st.groups
        calls.append(((self.p, self.cfg, self.enc, self.enc_proj2, h0,
                       self.group, b // g if g > 1 else None, self.k), out))
        return out

    monkeypatch.setattr(tst._NoteDecode, "decode", spy)
    _weak_model(eos_bias)(_spec(b), decode_chunk=CHUNK, decode_dtype=dtype)
    monkeypatch.setattr(tst._NoteDecode, "decode", decode)
    assert len(calls) == CFG.max_bars
    return calls


def _traced(fn):
    """fn() inside a decode/notes span under the profiler; (its result, the
    span's counts)."""
    P.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("decode/notes", ranged=False):
            out = fn()
    span, = [r for r in P.records(*EVERYTHING) if r.name == "decode/notes"]
    P.RECORDER.clear()
    return out, span.counts


def _stop_steps(out, chunk, b):
    """(2, groups) steps each stop group ran: the steps whose log-prob rows
    are not all zero in the group's first row, as the buffers stay zero
    after a group's stop."""
    g = b // chunk if chunk else 1
    return [[int((logp[r * (b // g)].abs().sum(-1) > 0).sum())
             for r in range(g)] for logp, _, _ in out]


@pytest.mark.parametrize("case,eos_bias,b,k,dtype", [
    ("one_group", EOS_BIAS, 4, 4, None),
    ("mixed_groups", EOS_BIAS, 32, 4, None),
    ("every_group_stops_inside_a_block", EOS_BIAS + 5.0, 32, 4, None),
    ("last_block_crosses_the_caps", -20.0, 32, 3, None),
    ("one_block_past_the_caps", EOS_BIAS, 32, tst.GRAPH_STEPS, None),
    ("bf16", EOS_BIAS, 32, 4, torch.bfloat16),
])
def test_graph_body_matches_the_eager_loop(monkeypatch, case, eos_bias, b, k,
                                           dtype):
    """Blocks of K steps equal single steps (K = 1, the loop the forward
    ran)."""
    calls = _bars(monkeypatch, eos_bias, b, dtype)
    caps, T = CFG.max_length, max(CFG.max_length)
    stops = []
    for (p, cfg, enc, enc_proj2, h0, group, chunk, one), forward in calls:
        assert group is None and chunk == (CHUNK if b > CHUNK else None)
        assert one == 1

        def decode(k):
            return tst._NoteDecode(p, cfg, enc, enc_proj2, chunk, k).bind(
                p, enc, enc_proj2).decode(h0)

        single, single_counts = _traced(lambda: decode(1))
        got, counts = _traced(lambda: decode(k))
        for want in (forward, got):
            for (s_logp, s_tok, s_len), (g_logp, g_tok, g_len) in zip(
                    single, want):
                assert g_logp.dtype == s_logp.dtype == torch.float32
                assert torch.equal(g_tok, s_tok) and torch.equal(g_len, s_len)
                assert torch.equal(g_logp, s_logp)
        stops.append(_stop_steps(single, chunk, b))
        # Single steps' counters, with the steps rounded up to whole
        # blocks; no graph ran.
        steps = single_counts["note_steps"]
        run = min(k * math.ceil(steps / k), k * math.ceil(T / k))
        assert counts == dict(single_counts, note_steps=run,
                              rows_computed=2 * b * run,
                              stop_read_ns=counts["stop_read_ns"])
    # Each case decodes what it is named for.
    ran = np.array(stops)                                  # (bars, 2, G)
    if case == "mixed_groups":
        assert ran.tolist() == MIXED
    if case == "bf16":
        assert (ran.min(-1) < ran.max(-1)).any() and ran.max() < T
    if case == "one_group":
        assert ran.shape[-1] == 1 and ran.max() < T
    if case == "every_group_stops_inside_a_block":
        assert ran.max() < k
    if case == "last_block_crosses_the_caps":
        assert (ran == np.array(caps)[None, :, None]).all() and T % k
    if case == "one_block_past_the_caps":
        assert k > T


def test_the_graph_path_is_taken_on_a_card_without_group_or_grad():
    """The rule the forward follows, on stand-ins for a card's tensors: a
    data-parallel group (its stop read is an all-reduce after every step)
    and a call with gradients run uncaptured single steps, as every CPU
    tensor does."""
    card = types.SimpleNamespace(is_cuda=True)
    with torch.no_grad():
        assert tst.runs_as_graph(card)
        assert not tst.runs_as_graph(card, group=object())
        assert not tst.runs_as_graph(torch.zeros(1))
    with torch.inference_mode():
        assert tst.runs_as_graph(card)
    with torch.enable_grad():
        assert not tst.runs_as_graph(card)


def test_a_copy_of_the_decoder_keeps_no_graph():
    """Captured graphs stay with the decoder that made them: a copy (or a
    pickle) starts with none."""
    import copy
    import pickle

    dec = _weak_model(EOS_BIAS).decoder
    dec._note_graphs._by_shape["shape"] = contextlib.nullcontext()
    for other in (copy.deepcopy(dec), pickle.loads(pickle.dumps(dec))):
        assert other._note_graphs._by_shape == {}
    assert dec._note_graphs._by_shape


def test_threads_share_one_cpu_model():
    """Off the card each forward makes its own decode and keeps none: two
    threads that run greedy forwards on one CPU model at once get what
    serial calls get."""
    model = _weak_model(EOS_BIAS)
    specs = [_spec(32, seed) for seed in range(1, 7)]
    with torch.no_grad():
        want = [model(x, decode_chunk=CHUNK) for x in specs]
    got, errors = [None] * len(specs), []
    start = threading.Barrier(2)

    def serve(first):
        try:
            start.wait()
            with torch.no_grad():
                for i in range(first, len(specs), 2):
                    got[i] = model(specs[i], decode_chunk=CHUNK)
        except BaseException as exc:  # re-raised on the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for g, w in zip(got, want):
        for a, b in zip(g[:4], w[:4]):
            assert torch.equal(a, b)
        for k in w[4]:
            assert torch.equal(g[4][k], w[4][k]), k
    assert model.decoder._note_graphs._by_shape == {}


# --- on the card -------------------------------------------------------------

# The paper's widths with short caps; a weak model (the ConvStack scaled,
# <eos> raised) whose stop groups of 16 stop at different steps, some of
# them inside the first block.
CARD_CFG = tst.ModelConfig(max_bars=2, max_length=(40, 24))
CARD_FRAMES, CARD_EOS_BIAS, CARD_CHUNK = 120, 1.5, 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


def _card_model(seed, dev):
    model = tst.ScoreTranscription(CARD_CFG)
    model.load_state_dict(init_state_dict(CARD_CFG, seed))
    with torch.no_grad():
        for d in (model.decoder.upper_decoder, model.decoder.lower_decoder):
            d.out.bias[CARD_CFG.eos] += CARD_EOS_BIAS
        for p in model.convstack.parameters():
            p.mul_(CONV_SCALE)
    return model.to(dev).eval()


def _card_spec(b, seed, dev):
    rng = np.random.RandomState(seed)
    scale = rng.choice([0.0, 0.3, 1, 3, 10], (b, 1, 1, 1))
    x = rng.randn(b, 1, CARD_FRAMES, CARD_CFG.freq_bins) * scale
    return torch.tensor(x.astype(np.float32), device=dev)


def _eager_forward(monkeypatch, model, spec, dtype=None):
    """The greedy forward with capture turned off (uncaptured single steps,
    K = 1, on the card)."""
    with monkeypatch.context() as m:
        m.setattr(tst, "runs_as_graph", lambda *a: False)
        return model(spec, decode_chunk=CARD_CHUNK, decode_dtype=dtype)


def _assert_same(got, want):
    """Tokens and lengths exactly, log-probs within 1e-6."""
    for k in want[4]:
        assert torch.equal(got[4][k], want[4][k]), k
    for g, w in zip(got[:4], want[:4]):
        assert (g - w).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 3, 16, 64])
def test_graph_path_matches_the_eager_loop_on_the_card(card, monkeypatch, b,
                                                       dtype):
    model = _card_model(0, card)
    spec = _card_spec(b, b, card)
    with torch.inference_mode():
        want = _eager_forward(monkeypatch, model, spec, dtype)
        assert not model.decoder._note_graphs._by_shape
        got = model(spec, decode_chunk=CARD_CHUNK, decode_dtype=dtype)
        again = model(spec, decode_chunk=CARD_CHUNK, decode_dtype=dtype)
    assert len(model.decoder._note_graphs._by_shape) == 1
    _assert_same(got, want)
    _assert_same(again, want)
    steps = [int((lp[0].abs().sum(-1) > 0).sum(-1).max()) for lp in want[2:4]]
    print(f"b={b} {dtype}: slowest stop by staff {steps}")


@pytest.mark.cuda
def test_graph_path_keeps_no_tensor_of_an_earlier_call(card, monkeypatch):
    """A second call with other inputs and other weights gives its own
    results, not the capture's; what the first call returned does not
    change; a call under no_grad follows one under inference_mode; the
    replayed steps are counted."""
    model = _card_model(0, card)
    spec1, spec2 = _card_spec(16, 1, card), _card_spec(16, 2, card)
    with torch.inference_mode():
        out1 = model(spec1, decode_chunk=CARD_CHUNK)
        kept = [x.clone() for x in out1[:4]] + [
            {k: v.clone() for k, v in out1[4].items()}]
    other = _card_model(1, card).state_dict()
    model.load_state_dict(other)
    with torch.no_grad():
        out2 = model(spec2, decode_chunk=CARD_CHUNK)
        want2 = _eager_forward(monkeypatch, model, spec2)
    assert len(model.decoder._note_graphs._by_shape) == 1
    _assert_same(out2, want2)
    for a, b in zip(out1[:4], kept[:4]):
        assert torch.equal(a, b)
    for k, v in kept[4].items():
        assert torch.equal(out1[4][k], v)
    assert not torch.equal(out1[2], out2[2])

    P.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.no_grad():
            model(spec2, decode_chunk=CARD_CHUNK)
        torch.cuda.synchronize()
    notes = [r for r in P.records(*EVERYTHING) if r.name == "decode/notes"]
    P.RECORDER.clear()
    assert len(notes) == CARD_CFG.max_bars
    for span in notes:
        c = span.counts
        assert c["graph_steps"] == c["note_steps"] > 0
        assert c["note_steps"] % tst.GRAPH_STEPS == 0
        assert c["rows_computed"] == 2 * 16 * c["note_steps"]
        assert 0 < c["rows_active"] <= c["rows_computed"]
