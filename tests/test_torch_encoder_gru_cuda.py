"""K4, the hand-written recurrence of the greedy encoder's GRU
(csrc/encoder_gru.cu, ``ops/encoder_gru_cuda.py``), and its plain twin
(``encoder_gru_plain`` here).

On the CPU: the twin, K4's algorithm in torch ops (the input half of every
step by one product a direction and layer; a cluster per (direction, chunk
of rows) whose CTAs each own a slice of the hidden units and keep their own
double-buffered copy of h, write their new slice into their own block and
send it to the others; G read a step ahead; rows past B padded with a G of
0 and never written), is held against ``nn.GRU`` in float64 at small sizes,
on several chunkings, and at the offline cell's
length (2, 1201, 256). Also the dispatch (``uses_k4``: a card, float32, no
gradient recorded; other widths then raise in the wrapper),
``Encoder.forward``'s counters and the wrapper's refusals.
tests/test_torch_layers.py holds the twin against the JAX package.

On the card (marked cuda): K4 against cuDNN's float32 call and both
against float64, for ``enc`` and ``h_n``, at B in {1, 3, 16, 64} and T in
{1, 2, 1201} (K4 within twice cuDNN's float32 error, or 1e-6), its launch
plan at the offline cell's batch, a deterministic call, a replay in a CUDA
graph, one launch a layer, and a training forward that launches none.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import init_state_dict
from piano_a2s_tpu_torch.ops import encoder_gru_cuda as K4
from piano_a2s_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

EVERYTHING = (0, 2 ** 63)
H = K4.HIDDEN
CPU_CFG = tst.ModelConfig(hidden_size=16, note_emb_size=8, staff_emb_size=8,
                          freq_bins=16, conv_feature_size=32, max_bars=2,
                          max_length=(10, 7))


# --- K4's plain twin ---------------------------------------------------------

def encoder_gru_plain(gru, x, rows=8):
    """(enc (B, T, 2H), h_n (4, B, H)) as K4 computes them, in the weights'
    dtype. Per layer: G = inp W_ih^T + b_ih a direction; then 2 x
    ceil(B / rows) clusters, all in lockstep: cluster k runs direction k % 2
    on rows [k // 2 * rows, ...), padded to ``rows`` with a G of 0. Each of
    its 16 CTAs owns U = H / 16 units and keeps a copy of h as blocks
    [2][16][rows][U]; step i reads buffer i % 2 of its own
    copy, writes its new slice into its own block of buffer (i + 1) % 2 and
    sends that block to every other CTA's copy. G of step i + 1 is read
    during step i."""
    B, T, _ = x.shape
    C = K4.CLUSTER
    U = H // C
    chunks = -(-B // rows)
    K = 2 * chunks
    dirs = torch.arange(K) % 2
    h_n = torch.empty(4, B, H, dtype=x.dtype)
    inp = x.reshape(B * T, -1)
    for layer in range(2):
        gs, w_hh, b_hh = [], [], []
        for suffix in ("", "_reverse"):
            w_ih = getattr(gru, f"weight_ih_l{layer}{suffix}")
            b_ih = getattr(gru, f"bias_ih_l{layer}{suffix}")
            g = torch.addmm(b_ih, inp, w_ih.t()).reshape(B, T, 3, C, U)
            pad = torch.zeros(chunks * rows - B, T, 3, C, U, dtype=g.dtype)
            gs.append(torch.cat([g, pad]).reshape(chunks, rows, T, 3, C, U))
            w_hh.append(getattr(gru, f"weight_hh_l{layer}{suffix}")
                        .reshape(3, C, U, H))
            b_hh.append(getattr(gru, f"bias_hh_l{layer}{suffix}")
                        .reshape(3, C, U))
        # Cluster k's G with its direction's steps in the order it runs
        # them: (K, rows, T, 3, C, U).
        g = torch.stack([gs[d][k // 2] if d == 0 else
                         gs[d][k // 2].flip(1) for k, d in
                         enumerate(dirs.tolist())])
        w = torch.stack(w_hh)[dirs]                      # (K, 3, C, U, H)
        bh = torch.stack(b_hh)[dirs]                     # (K, 3, C, U)
        # Each CTA's copy of h: (K, CTA, buffer, block, rows, U).
        copies = torch.zeros(K, C, 2, C, rows, U, dtype=x.dtype)
        out = torch.empty(K, rows, T, C, U, dtype=x.dtype)
        gbuf = g[:, :, 0]
        for i in range(T):
            cur, nxt = i % 2, (i + 1) % 2
            g_next = g[:, :, i + 1] if i + 1 < T else None
            # CTA c's full h: its own copy's blocks side by side.
            h_full = copies[:, :, cur].permute(0, 1, 3, 2, 4).reshape(
                K, C, rows, H)
            hp = torch.einsum("kcrh,kgcuh->kcrgu", h_full, w) \
                + bh.permute(0, 2, 1, 3)[:, :, None]
            own_prev = copies[:, torch.arange(C), cur, torch.arange(C)]
            gc = gbuf.permute(0, 3, 1, 2, 4)             # (K, C, rows, 3, U)
            r = torch.sigmoid(gc[:, :, :, 0] + hp[:, :, :, 0])
            z = torch.sigmoid(gc[:, :, :, 1] + hp[:, :, :, 1])
            n = torch.tanh(gc[:, :, :, 2] + r * hp[:, :, :, 2])
            new = (1 - z) * n + z * own_prev             # (K, C, rows, U)
            out[:, :, i] = new.permute(0, 2, 1, 3)
            # Own block, then one bulk copy to each other CTA: every copy's
            # buffer nxt holds every CTA's new block.
            copies[:, :, nxt] = new[:, None]
            gbuf = g_next
        out = out.reshape(K, rows, T, H)
        enc = torch.empty(B, T, 2 * H, dtype=x.dtype)
        for k, d in enumerate(dirs.tolist()):
            lo = k // 2 * rows
            live = min(rows, B - lo)
            seq = out[k, :live]
            if d:
                seq = seq.flip(1)
            enc[lo:lo + live, :, d * H:(d + 1) * H] = seq
            h_n[2 * layer + d, lo:lo + live] = out[k, :live, T - 1]
        inp = enc.reshape(B * T, 2 * H)
    return enc, h_n


def _gru(dtype=torch.float64, seed=0):
    torch.manual_seed(seed)
    return torch.nn.GRU(H, H, num_layers=2, bidirectional=True,
                        batch_first=True).to(dtype)


def _x(shape, seed, dtype=torch.float64):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)).to(
        dtype)


# --- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("B,T,rows", [
    (1, 1, 8), (3, 5, 8), (9, 4, 8), (8, 6, 8), (17, 3, 24), (20, 2, 16)])
def test_the_twin_matches_nn_gru(B, T, rows):
    """One chunk and several, one group of 8 rows a cluster and several,
    rows padded past B."""
    gru = _gru()
    x = _x((B, T, H), B + T)
    with torch.no_grad():
        enc, h_n = encoder_gru_plain(gru, x, rows)
        want, want_h = gru(x)
    torch.testing.assert_close(enc, want, rtol=0, atol=1e-12)
    torch.testing.assert_close(h_n, want_h, rtol=0, atol=1e-12)


def test_the_twin_at_the_cells_length():
    """(2, 1201, 256): every frame of a 12 s clip, in float64."""
    gru = _gru(seed=1)
    x = _x((2, 1201, H), 3)
    with torch.no_grad():
        enc, h_n = encoder_gru_plain(gru, x)
        want, want_h = gru(x)
    torch.testing.assert_close(enc, want, rtol=0, atol=1e-12)
    torch.testing.assert_close(h_n, want_h, rtol=0, atol=1e-12)


def _card_like(dtype=torch.float32, requires_grad=False):
    return types.SimpleNamespace(is_cuda=True, dtype=dtype,
                                 requires_grad=requires_grad)


def test_uses_k4_follows_device_dtype_gradients_and_widths():
    """Device, dtype and gradients decide; other widths on a card take K4
    too, whose wrapper refuses them rather than fall back to nn.GRU."""
    gru = _gru(torch.float32)
    x = torch.zeros(1, 2, H)
    with torch.no_grad():
        assert tst.uses_k4(_card_like(), gru)
        assert not tst.uses_k4(x, gru)                     # the CPU
        assert not tst.uses_k4(_card_like(torch.float64), gru)
        assert not tst.uses_k4(_card_like(), gru.double())
        gru.float()
        small = torch.nn.GRU(32, 16, num_layers=2, bidirectional=True,
                             batch_first=True)
        one = torch.nn.GRU(H, H, bidirectional=True, batch_first=True)
        for other in (small, one):                         # other widths
            assert tst.uses_k4(_card_like(), other)
            with pytest.raises(ValueError, match="K4 takes"):
                K4.encoder_gru_cuda(other, torch.zeros(1, 2, H))
    # Gradients recorded, for the weights or for the input: nn.GRU.
    assert not tst.uses_k4(_card_like(), gru)
    with torch.inference_mode():
        assert tst.uses_k4(_card_like(), gru)
    gru.requires_grad_(False)
    assert tst.uses_k4(_card_like(), gru)
    assert not tst.uses_k4(_card_like(requires_grad=True), gru)


def _counts(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("forward/encoder", ranged=False):
            out = fn()
    span, = [r for r in P.records(*EVERYTHING)
             if r.name == "forward/encoder"]
    P.RECORDER.clear()
    return out, span.counts


def test_encoder_dispatch_and_count(monkeypatch):
    """The CPU takes nn.GRU and counts no kernel rows; where uses_k4
    holds, K4's wrapper answers with a contiguous input, and every row
    counts as the kernel's."""
    P.RECORDER.clear()
    enc_mod = tst.Encoder(tst.ModelConfig()).double().eval()
    x = _x((3, 4, H), 9)
    with torch.no_grad():
        want = enc_mod(x)
        out, counts = _counts(lambda: enc_mod(x))
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert counts == {"encoder_rows": 3, "encoder_kernel_rows": 0}

    calls = []

    def stand_in(gru, inp):
        calls.append(inp.is_contiguous())
        return encoder_gru_plain(gru, inp)

    monkeypatch.setattr(tst, "uses_k4", lambda *a: True)
    monkeypatch.setattr(K4, "encoder_gru_cuda", stand_in)
    strided = _x((4, 3, H), 9).transpose(0, 1)
    with torch.no_grad():
        out, counts = _counts(lambda: enc_mod(strided))
    assert calls == [True]
    assert counts == {"encoder_rows": 3, "encoder_kernel_rows": 3}
    monkeypatch.setattr(tst, "uses_k4", lambda *a: False)
    with torch.no_grad():
        want = enc_mod(strided)
    for a, b in zip(out, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_a_training_forward_counts_no_kernel_rows(monkeypatch):
    """The teacher-forced forward with gradients: the encoder runs nn.GRU,
    K4's wrapper is never called, even with a card's input assumed."""
    from piano_a2s_tpu_torch.train.synthetic import random_targets

    def refuse(*a, **k):
        raise AssertionError("K4 launched")

    monkeypatch.setattr(K4, "encoder_gru_cuda", refuse)
    real = tst.uses_k4
    monkeypatch.setattr(tst, "uses_k4", lambda x, gru: real(
        _card_like(requires_grad=x.requires_grad), gru))
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
    encoder, = [r for r in recs if r.name == "forward/encoder"]
    assert encoder.counts == {"encoder_rows": 2, "encoder_kernel_rows": 0}


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA"), ("float64", TypeError, "float32"),
    ("strided", ValueError, "contiguous"),
    ("hidden_128", ValueError, "input and hidden size 256"),
    ("input_128", ValueError, "input and hidden size 256"),
    ("one_layer", ValueError, "2-layer"),
    ("unidirectional", ValueError, "bidirectional"),
    ("time_first", ValueError, "batch-first"),
    ("width", ValueError, r"input \(B, T, 256\)")])
def test_the_wrapper_raises_on_what_it_does_not_take(monkeypatch, case,
                                                     error, match):
    """No fallback: each refusal comes before the library is loaded."""
    monkeypatch.setattr(K4, "_library", None)
    size = {"hidden_128": (H, 128), "input_128": (128, H)}.get(case, (H, H))
    gru = torch.nn.GRU(*size, num_layers=1 if case == "one_layer" else 2,
                       bidirectional=case != "unidirectional",
                       batch_first=case != "time_first")
    x = torch.zeros(2, 3, H)
    if case == "float64":
        gru, x = gru.double(), x.double()
    elif case == "strided":
        x = torch.zeros(3, 2, H).transpose(0, 1)
    elif case == "width":
        x = torch.zeros(2, 3, 128)
    # The module's, dtypes' and layouts' checks come before the devices',
    # so CPU operands show each refusal.
    with pytest.raises(error, match=match):
        K4.encoder_gru_cuda(gru, x)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K4 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _three_ways(card, x):
    """(K4, cuDNN float32, cuDNN float64) of x through one set of weights,
    each (enc, h_n) in float64."""
    gru = _gru(torch.float32).to(card)
    gru64 = _gru(torch.float32).double().to(card)
    with torch.no_grad():
        k4 = K4.encoder_gru_cuda(gru, x)
        plain = gru(x)
        ref = gru64(x.double())
    torch.cuda.synchronize()
    return ([t.double() for t in k4], [t.double() for t in plain], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16, 64])
@pytest.mark.parametrize("T", [1, 2, 1201])
def test_k4_matches_nn_gru_on_the_card(card, B, T):
    x = _x((B, T, H), B * T, torch.float32).to(card)
    k4, plain, ref = _three_ways(card, x)
    for name, got, cudnn, want in zip(("enc", "h_n"), k4, plain, ref):
        assert got.shape == want.shape
        err = (got - want).abs().max().item()
        plain_err = (cudnn - want).abs().max().item()
        print(f"({B}, {T}) {name}: K4 against float64 {err:.3e}, cuDNN "
              f"float32 {plain_err:.3e}")
        assert err <= max(2 * plain_err, 1e-6)


@pytest.mark.cuda
def test_k4_is_deterministic_and_replays_in_a_cuda_graph(card):
    """Two calls are equal bit for bit; a captured call counts no launch
    and, replayed on a new input, equals an uncaptured call."""
    gru = _gru(torch.float32).to(card)
    x = _x((16, 64, H), 6, torch.float32).to(card)
    with torch.no_grad():
        a = K4.encoder_gru_cuda(gru, x)
        b = K4.encoder_gru_cuda(gru, x)
        torch.cuda.synchronize()
        assert all(torch.equal(p, q) for p, q in zip(a, b))
        side = torch.cuda.Stream(card)
        side.wait_stream(torch.cuda.current_stream(card))
        graph = torch.cuda.CUDAGraph()
        before = K4.encoder_gru_cuda.launches
        with torch.cuda.graph(graph, stream=side):
            out = K4.encoder_gru_cuda(gru, x)
        assert K4.encoder_gru_cuda.launches == before
        x.copy_(_x((16, 64, H), 7, torch.float32))
        graph.replay()
        want = K4.encoder_gru_cuda(gru, x)
        torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(out, want))


@pytest.mark.cuda
def test_the_plan_fits_the_card(card):
    """Every cluster of the offline cell's batch resident at once."""
    rows, clusters, resident = K4.plan(16)
    print(f"plan at 16 rows: {rows} rows a cluster, {clusters} clusters, "
          f"{resident} resident")
    assert rows % 8 == 0
    assert clusters == 2 * -(-16 // rows) <= resident


@pytest.mark.cuda
def test_the_wrapper_raises_on_a_width_on_the_card(card):
    """Also through the encoder: a float32 call with no gradient at other
    widths raises, and does not fall back to nn.GRU."""
    gru = torch.nn.GRU(H, 128, num_layers=2, bidirectional=True,
                       batch_first=True).to(card)
    with pytest.raises(ValueError, match="input and hidden size 256"):
        K4.encoder_gru_cuda(gru, torch.zeros(2, 3, H, device=card))
    encoder = tst.Encoder(CPU_CFG).to(card).eval()
    with torch.no_grad(), pytest.raises(ValueError, match="K4 takes"):
        encoder(torch.zeros(2, 3, CPU_CFG.conv_feature_size, device=card))
    with pytest.raises(TypeError, match="float32"):
        K4.encoder_gru_cuda(_gru(torch.float64).to(card),
                            torch.zeros(2, 3, H, device=card,
                                        dtype=torch.float64))


@pytest.mark.cuda
def test_uses_k4_on_the_card(card):
    gru = _gru(torch.float32).to(card)
    x = torch.zeros(2, 3, H, device=card)
    with torch.no_grad():
        assert tst.uses_k4(x, gru)
        assert not tst.uses_k4(x.double(), gru.double())
    assert not tst.uses_k4(x, gru.float())


@pytest.mark.cuda
def test_a_greedy_forward_launches_k4_once_a_layer(card):
    """The paper's widths: one encoder call, two launches, every row
    counted as K4's; a training forward launches none."""
    from piano_a2s_tpu_torch.train.synthetic import random_targets

    cfg = tst.ModelConfig(max_bars=2, max_length=(40, 24))
    model = tst.ScoreTranscription(cfg)
    model.load_state_dict(init_state_dict(cfg, 0))
    model = model.to(card).eval()
    spec = torch.randn(4, 1, 120, cfg.freq_bins, device=card)
    with torch.inference_mode():
        model(spec)                                   # the capture
        P.RECORDER.clear()
        K4.encoder_gru_cuda.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            model(spec)
    recs = P.records(*EVERYTHING)
    P.RECORDER.clear()
    encoder, = [r for r in recs if r.name == "forward/encoder"]
    assert encoder.counts == {"encoder_rows": 4, "encoder_kernel_rows": 4}
    assert K4.encoder_gru_cuda.launches == 2

    model.train()
    batch = random_targets(cfg, 2, seed=1)
    gt = tuple(torch.as_tensor(batch[k], device=card) for k in (
        "time_sig", "key", "upper", "upper_lengths", "lower",
        "lower_lengths"))
    K4.encoder_gru_cuda.launches = 0
    out = model(torch.randn(2, 1, 120, cfg.freq_bins, device=card),
                train=True, ground_truth=gt, tf_ratio=0.5,
                generator=torch.Generator(card).manual_seed(0))
    sum(x.float().sum() for x in out[:4]).backward()
    torch.cuda.synchronize()
    assert K4.encoder_gru_cuda.launches == 0
