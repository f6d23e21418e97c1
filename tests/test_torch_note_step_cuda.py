"""K2, the hand-written greedy note-decoder step (csrc/note_step.cu,
``ops/note_step_cuda.py``), and its plain twin (``note_step_plain`` here).

On the CPU: the twin, K2's algorithm in torch ops (the frames split into
the kernel's chunks, each chunk's largest score, sum and context merged
with the online-softmax rescale, inactive pairs computing nothing), is
held against the model's torch-op step (``_masked_step`` around
``_fast_step``) in float64, where the two orders of the sums agree to
about 1e-13; the wrapper's refusals; which step ``_masked_step`` takes.

On the card (marked cuda): K2 against the torch-op step in float32 and
both against float64. K2 against float64 must be within 2x the torch-op
step's own float32 error, or 1e-5. Tolerance between the two float32
steps: 16 float32 ulps (2^-23) of the largest log-prob magnitude. Both sum
in other orders (1201 frames of scores and contexts, 512- and 1024-deep
products); at these weights the log-probs reach about 17, where the
torch-op step is within 8.5 ulps of float64 (1.63e-5) and K2 within 3
(5.6e-6), so their difference stays under the sum of the two. Tokens must
be equal to float64's wherever its top-two margin exceeds the tolerance.
Inactive rows keep h2, tok2, lengths and done bit for bit.
"""

import types

import numpy as np
import pytest
import torch

from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import init_state_dict
from piano_a2s_tpu_torch.ops import gru as G
from piano_a2s_tpu_torch.ops import note_step as NS
from piano_a2s_tpu_torch.ops import note_step_cuda as K2

torch.set_num_threads(2)

# Small widths on the CPU; the card runs the paper's.
CPU_CFG = tst.ModelConfig(hidden_size=16, note_emb_size=8, staff_emb_size=8,
                          freq_bins=16, conv_feature_size=32)
MASKS = ("both", "lower_past_cap", "one_group_done", "every_pair_done")
SHAPES = [(1, None), (3, None), (16, None), (64, 16)]   # (rows, chunk)
CARD_ULPS = 16 * 2.0 ** -23   # of the largest log-prob magnitude


# --- K2's plain twin ---------------------------------------------------------

def chunked_attention(q, v, enc_proj, enc, chunks):
    """Context of additive attention, chunk by chunk: q (n, H), v (H,),
    enc_proj (n, T, H), enc (n, T, D) -> (n, D)."""
    T = enc.shape[1]
    size = -(-T // chunks)
    ms, ls, cs = [], [], []
    for t0 in range(0, T, size):
        e = torch.tanh(enc_proj[:, t0:t0 + size] + q[:, None]) @ v  # (n, Tc)
        m = e.amax(dim=1)
        p = torch.exp(e - m[:, None])
        ms.append(m)
        ls.append(p.sum(dim=1))
        cs.append(torch.einsum("nt,ntd->nd", p, enc[:, t0:t0 + size]))
    m = torch.stack(ms)                                # (chunks, n)
    scale = torch.exp(m - m.amax(dim=0))
    total = (torch.stack(ls) * scale).sum(dim=0)
    return (torch.stack(cs) * scale[:, :, None]).sum(dim=0) / total[:, None]


def note_step_plain(p, enc, enc_proj2, h2, tok2, lengths, done, t, caps,
                    logp, pred, eos, groups):
    """One step in place, as K2 computes it over the kernel's chunks
    (``ops.note_step_cuda.note_step_cuda`` takes the same state, its
    scratch aside): ``p`` a DualDecodeParams; h2, tok2, lengths, done and
    t (0-dim, + 1) are updated in the active rows (``step_mask``), logp
    (2, B, V) and pred (2, B) written, zero in the others. The next query
    comes from h2 here, where the kernel keeps the product from the step
    before."""
    m = NS.step_mask(done, t, caps, groups)
    t += 1
    chunks = NS.pick_chunks(enc.shape[0], enc.shape[1])[0]
    n_gates = p.b_hh.shape[-1]
    logp.zero_()
    pred.zero_()
    for s in range(2):
        rows = m[s].nonzero()[:, 0]
        if not len(rows):
            continue
        h = h2[s, rows]
        hq = h @ p.w_hq[s]
        ctx = chunked_attention(hq[:, n_gates:], p.v[s], enc_proj2[s, rows],
                                enc[rows], chunks)
        x = tok2[s, rows] + ctx @ p.w_ih_ctx[s] + p.b_ih[s]
        h_new = G.gru_gates(x, hq[:, :n_gates] + p.b_hh[s], h)
        out = torch.cat([h_new, ctx], dim=-1) @ p.w_out[s] + p.b_out[s]
        lp = torch.log_softmax(out, dim=-1)
        a = lp.argmax(dim=-1)
        h2[s, rows] = h_new
        logp[s, rows] = lp
        pred[s, rows] = a
        stop = rows[a == eos]
        lengths[s, stop] = t
        done[s, stop] = True
        tok2[s, rows] = p.emb_proj[s, a]


def _decoders(cfg, seed, eos_bias=0.0, dtype=torch.float64):
    torch.manual_seed(seed)
    up, low = tst.NoteDecoder(cfg), tst.NoteDecoder(cfg)
    with torch.no_grad():
        for d in (up, low):
            for prm in d.parameters():
                prm.uniform_(-0.3, 0.3)
            d.out.bias[cfg.eos] += eos_bias
    return up.to(dtype), low.to(dtype)


def _operands(cfg, rows, frames, seed, dtype, dev="cpu", eos_bias=0.0):
    """(p, enc, enc_proj2, h0) of random weights and encoder outputs."""
    up, low = _decoders(cfg, seed, eos_bias, dtype)
    rng = np.random.RandomState(seed)
    enc = torch.tensor(np.tanh(rng.randn(rows, frames, 2 * cfg.hidden_size))
                       .astype(np.float32)).to(dtype)
    h0 = torch.tensor(np.tanh(rng.randn(rows, 2 * cfg.hidden_size))
                      .astype(np.float32)).to(dtype)
    with torch.no_grad():
        ep2 = torch.stack([torch.nn.functional.linear(
            enc, d.attn.w_enc, d.attn.attn.bias) for d in (up, low)])
        p = tst.dual_decode_params(up, low, cfg)
    move = dict(device=dev)
    p = tst.DualDecodeParams(**{k: v.to(**move).contiguous()
                                for k, v in vars(p).items()})
    return p, enc.to(**move), ep2.to(**move), h0.to(**move)


def _state(p, cfg, enc, h0, chunk, mask, rng_seed=0):
    """A decode state at the start of a step whose active pairs ``mask``
    names."""
    st = tst._DecodeState(p, cfg, enc, chunk).bind(p)
    B = enc.shape[0]
    sos = torch.full((2, B), cfg.sos, dtype=torch.long, device=enc.device)
    st.reset(p, h0, tst._tok_proj(p, sos))
    g = torch.Generator().manual_seed(rng_seed)
    # A few steps' worth of state: h and tok2 moved off their start.
    st.h2.copy_(torch.tanh(torch.randn(st.h2.shape, generator=g,
                                       dtype=torch.float64)).to(st.h2))
    st.tok2.copy_(tst._tok_proj(p, torch.randint(
        0, cfg.vocab_size, (2, B), generator=g).to(enc.device)))
    if mask == "lower_past_cap":
        st.t.fill_(cfg.max_length[1] + 2)
    elif mask == "every_pair_done":
        st.t.fill_(max(cfg.max_length))
    elif mask == "one_group_done":
        rows = B // st.groups
        st.done[0, :rows] = True            # the upper staff's first group
        st.lengths[0, :rows] = 3
    if st.work is not None:
        K2.note_step_prologue(p, st.work, st.h2)
    return st


def _snapshot(st):
    return {k: getattr(st, k).clone()
            for k in ("h2", "tok2", "lengths", "done", "t")}


def _step(p, cfg, enc, ep2, st, fn):
    B = enc.shape[0]
    logp = torch.full((2, B, cfg.vocab_size), 7.0, dtype=torch.float32
                      if enc.dtype != torch.float64 else torch.float64,
                      device=enc.device)
    pred = torch.full((2, B), -1, dtype=torch.long, device=enc.device)
    fn(logp, pred)
    return logp, pred


def _active(cfg, st_before, chunk, B):
    m = NS.step_mask(st_before["done"], st_before["t"],
                     torch.tensor(cfg.max_length,
                                  device=st_before["t"].device)[:, None],
                     B // chunk if chunk else 1)
    return m


# --- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("frames", [1201, 333])
@pytest.mark.parametrize("rows,chunk", SHAPES)
def test_the_plain_twin_matches_the_torch_op_step(rows, chunk, frames, mask):
    cfg = CPU_CFG
    p, enc, ep2, h0 = _operands(cfg, rows, frames, rows + frames,
                                torch.float64, eos_bias=1.0)
    outs = []
    for twin in (False, True):
        st = _state(p, cfg, enc, h0, chunk, mask)
        before = _snapshot(st)
        if twin:
            def fn(logp, pred):
                note_step_plain(p, enc, ep2, st.h2, st.tok2, st.lengths,
                                   st.done, st.t, st.caps, logp, pred,
                                   cfg.eos, st.groups)
        else:
            def fn(logp, pred):
                tst._masked_step(p, cfg, enc, ep2, st, logp, pred)
        logp, pred = _step(p, cfg, enc, ep2, st, fn)
        outs.append((logp, pred, _snapshot(st), before))
    (lp0, pr0, s0, before), (lp1, pr1, s1, _) = outs
    m = _active(cfg, before, chunk, rows)
    assert (lp0 - lp1).abs().max().item() <= 1e-12
    assert torch.equal(pr0, pr1)
    assert (s0["h2"] - s1["h2"]).abs().max().item() <= 1e-13
    for k in ("tok2", "lengths", "done", "t"):
        assert torch.equal(s0[k], s1[k]), k
    # Inactive rows: state kept bit for bit, zero log-probs and tokens.
    off = ~m
    for k in ("h2", "tok2"):
        assert torch.equal(s1[k][off], before[k][off]), k
    for k in ("lengths", "done"):
        assert torch.equal(s1[k][off], before[k][off]), k
    assert not lp1[off].any() and not pr1[off].any()
    expect_active = {"both": 2 * rows, "lower_past_cap": rows,
                     "every_pair_done": 0,
                     "one_group_done": 2 * rows - (rows // (rows // chunk)
                                                   if chunk else rows)}[mask]
    assert int(m.sum()) == expect_active


def test_the_twin_takes_the_kernels_chunks():
    """The chunked attention equals the one-pass softmax for any split."""
    g = torch.Generator().manual_seed(0)
    q, v = torch.randn(3, 8, generator=g, dtype=torch.float64), \
        torch.randn(8, generator=g, dtype=torch.float64)
    ep = torch.randn(3, 50, 8, generator=g, dtype=torch.float64)
    enc = torch.randn(3, 50, 6, generator=g, dtype=torch.float64)
    w = torch.softmax(torch.tanh(ep + q[:, None]) @ v, dim=-1)
    want = torch.einsum("nt,ntd->nd", w, enc)
    for chunks in (1, 2, 7, 50):
        got = chunked_attention(q, v, ep, enc, chunks)
        assert (got - want).abs().max().item() <= 1e-14


@pytest.mark.parametrize("rows", list(range(1, 17)) + [24, 32, 64])
def test_the_chunks_cover_the_card(rows):
    """Every batch the port serves fills the 132 SMs (or has a chunk of
    every 16 frames) in one wave of two blocks an SM, with no chunk
    empty."""
    chunks, size = NS.pick_chunks(rows, 1201)
    assert (chunks - 1) * size < 1201 <= chunks * size
    assert rows * chunks >= 132 or size <= NS.MIN_CHUNK_FRAMES
    assert rows * chunks <= NS.TARGET_BLOCKS
    assert chunks <= NS.MAX_CHUNKS


def _k2_args(dtype=torch.float32, dev="cpu", contiguous=True):
    cfg = tst.ModelConfig()
    p, enc, ep2, h0 = _operands(cfg, 2, 8, 0, dtype)
    st = types.SimpleNamespace(**{
        "h2": torch.zeros(2, 2, 512, dtype=dtype),
        "tok2": torch.zeros(2, 2, 1536, dtype=dtype),
        "lengths": torch.zeros(2, 2, dtype=torch.long),
        "done": torch.zeros(2, 2, dtype=torch.bool),
        "t": torch.zeros((), dtype=torch.long),
        "caps": torch.tensor(cfg.max_length)[:, None]})
    work = K2.NoteStepWork(p, 2, 8, 1, torch.device("cpu"))
    if not contiguous:
        enc = enc.transpose(0, 1).contiguous().transpose(0, 1)
    logp = torch.zeros(2, 2, cfg.vocab_size, dtype=torch.float32)
    pred = torch.zeros(2, 2, dtype=torch.long)
    return (p, work, enc, ep2, st.h2, st.tok2, st.lengths, st.done, st.t,
            st.caps, logp, pred, cfg.eos)


@pytest.mark.parametrize("case,error", [
    ("bf16", TypeError), ("non_contiguous", ValueError), ("cpu", ValueError)])
def test_the_wrapper_raises_on_what_it_does_not_take(monkeypatch, case,
                                                     error):
    """No fallback: a bf16, a strided or a CPU operand raises before the
    library is loaded."""
    monkeypatch.setattr(K2, "_library", None)
    args = _k2_args(torch.bfloat16 if case == "bf16" else torch.float32,
                    contiguous=case != "non_contiguous")
    with pytest.raises(error, match={"bf16": "float32",
                                     "non_contiguous": "contiguous",
                                     "cpu": "CUDA"}[case]):
        K2.note_step_cuda(*args)


def test_masked_step_takes_k2_only_for_cuda_float32(monkeypatch):
    """uses_k2 follows the device and the dtype alone (a toy width on a
    card takes K2 too, whose scratch then refuses it); _masked_step then
    launches K2, and otherwise runs the torch ops around _fast_step."""
    def card(dtype, width=K2.D):
        return types.SimpleNamespace(is_cuda=True, dtype=dtype,
                                     shape=(16, 1201, width))

    assert tst.uses_k2(card(torch.float32))
    assert tst.uses_k2(card(torch.float32, 32))
    for other in (card(torch.bfloat16), card(torch.float64),
                  torch.zeros(1, 2, K2.D),
                  torch.zeros(1, 2, K2.D, dtype=torch.float64)):
        assert not tst.uses_k2(other)
    p, *_ = _operands(CPU_CFG, 2, 9, 0, torch.float32)
    with pytest.raises(ValueError, match="built for a decoder hidden"):
        K2.NoteStepWork(p, 2, 9, 1, torch.device("cpu"))

    cfg = CPU_CFG
    p, enc, ep2, h0 = _operands(cfg, 2, 9, 0, torch.float32)
    calls = []
    fast = tst._fast_step

    def spy_fast(*a):
        calls.append("torch")
        return fast(*a)

    monkeypatch.setattr(tst, "_fast_step", spy_fast)
    monkeypatch.setattr(K2, "note_step_cuda",
                        lambda *a, **k: calls.append("k2"))
    st = _state(p, cfg, enc, h0, None, "both")
    logp = torch.zeros(2, 2, cfg.vocab_size)
    pred = torch.zeros(2, 2, dtype=torch.long)
    tst._masked_step(p, cfg, enc, ep2, st, logp, pred)
    monkeypatch.setattr(tst, "uses_k2", lambda x: True)
    tst._masked_step(p, cfg, enc, ep2, st, logp, pred)
    assert calls == ["torch", "k2"]


def test_the_bf16_decode_and_the_teacher_forced_step_keep_their_ops(
        monkeypatch):
    """With K2 taken for every tensor (uses_k2 forced on, its launches
    raising), a bf16 greedy step still runs the torch ops (its operands
    are bf16), and a teacher-forced training forward reaches no greedy
    step at all."""
    from piano_a2s_tpu_torch.train.synthetic import random_targets

    def refuse(*a, **k):
        raise AssertionError("K2 launched")

    cfg = CPU_CFG
    p, enc, ep2, h0 = _operands(cfg, 2, 9, 0, torch.float32)
    bf = tst.DualDecodeParams(**{k: v.to(torch.bfloat16)
                                 for k, v in vars(p).items()})
    st = _state(bf, cfg, enc.bfloat16(), h0.bfloat16(), None, "both")
    monkeypatch.setattr(K2, "note_step_cuda", refuse)
    monkeypatch.setattr(K2, "note_step_prologue", refuse)
    logp = torch.zeros(2, 2, cfg.vocab_size)
    pred = torch.zeros(2, 2, dtype=torch.long)
    tst._masked_step(bf, cfg, enc.bfloat16(), ep2.bfloat16(), st, logp, pred)
    assert torch.isfinite(logp).all() and logp.any()

    monkeypatch.setattr(tst, "uses_k2",
                        lambda x: x.dtype == torch.float32)
    tcfg = tst.ModelConfig(hidden_size=16, note_emb_size=8, staff_emb_size=8,
                           freq_bins=16, conv_feature_size=32, max_bars=2,
                           max_length=(10, 7))
    model = tst.ScoreTranscription(tcfg)
    model.load_state_dict(init_state_dict(tcfg, 0))
    batch = random_targets(tcfg, 2, seed=1)
    spec = torch.randn(2, 1, 20, tcfg.freq_bins)
    out = model(spec, train=True, ground_truth=(
        torch.as_tensor(batch["time_sig"]), torch.as_tensor(batch["key"]),
        torch.as_tensor(batch["upper"]),
        torch.as_tensor(batch["upper_lengths"]),
        torch.as_tensor(batch["lower"]),
        torch.as_tensor(batch["lower_lengths"])), tf_ratio=0.5,
        generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(x).all() for x in out[:4])


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("frames", [1201, 333])
@pytest.mark.parametrize("rows,chunk", SHAPES)
def test_k2_matches_the_torch_op_step_on_the_card(card, monkeypatch, rows,
                                                  chunk, frames, mask):
    cfg = tst.ModelConfig()
    got = {}
    for name in ("k2", "f32", "f64"):
        dtype = torch.float64 if name == "f64" else torch.float32
        p, enc, ep2, h0 = _operands(cfg, rows, frames, rows + frames, dtype,
                                    card, eos_bias=4.0)
        with monkeypatch.context() as m:
            m.setattr(tst, "uses_k2", lambda x, k=name == "k2": k and
                      x.is_cuda and x.dtype == torch.float32)
            st = _state(p, cfg, enc, h0, chunk, mask)
            before = _snapshot(st)

            def fn(logp, pred):
                tst._masked_step(p, cfg, enc, ep2, st, logp, pred)
            logp, pred = _step(p, cfg, enc, ep2, st, fn)
            torch.cuda.synchronize()
        got[name] = (logp.double(), pred, _snapshot(st), before)
    lp, pr, after, before = got["k2"]
    lp32, pr32, after32, _ = got["f32"]
    lp64, pr64, _, _ = got["f64"]
    m = _active(cfg, before, chunk, rows)
    err = (lp - lp32).abs().max().item()
    err64, plain64 = ((lp - lp64).abs().max().item(),
                      (lp32 - lp64).abs().max().item())
    tol = CARD_ULPS * max(1.0, lp64.abs().max().item())
    print(f"rows {rows} frames {frames} {mask}: |K2 - f32| {err:.2e} "
          f"(tolerance {tol:.2e}), against f64 K2 {err64:.2e} f32 "
          f"{plain64:.2e}")
    assert err <= tol
    assert err64 <= max(2 * plain64, 1e-5)
    top2 = lp64.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    assert torch.equal(pr[clear & m], pr64[clear & m])
    assert not lp[~m].any() and not pr[~m].any()
    off = ~m
    for k in ("h2", "tok2", "lengths", "done"):
        assert torch.equal(after[k][off], before[k][off]), k
    assert int(after["t"]) == int(before["t"]) + 1
    # Active rows: the state moved as the torch-op step moved it.
    assert torch.equal(after["done"], after32["done"])
    assert torch.equal(after["lengths"], after32["lengths"])
    assert (after["h2"] - after32["h2"]).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_a_graph_decode_on_k2_equals_the_eager_loop_on_the_card(
        card, monkeypatch):
    """A whole greedy forward at the paper's widths: the replayed graphs of
    K2 steps give the tokens and lengths of uncaptured single steps (which
    run K2 too); both count four K2 launches a step and one a bar, and
    every step's attention kernel starts inside its bar's decode/notes
    span."""
    from torch.profiler import ProfilerActivity, profile

    from piano_a2s_tpu_torch.utils import profiling as P

    cfg = tst.ModelConfig(max_bars=2, max_length=(40, 24))
    model = tst.ScoreTranscription(cfg)
    model.load_state_dict(init_state_dict(cfg, 0))
    with torch.no_grad():
        for d in (model.decoder.upper_decoder, model.decoder.lower_decoder):
            d.out.bias[cfg.eos] += 1.5
        for prm in model.convstack.parameters():
            prm.mul_(3.0)
    model = model.to(card).eval()
    rng = np.random.RandomState(3)
    spec = torch.tensor((rng.randn(32, 1, 120, cfg.freq_bins) * rng.choice(
        [0.3, 1, 3, 10], (32, 1, 1, 1))).astype(np.float32), device=card)
    with torch.inference_mode():
        model(spec, decode_chunk=16)       # the capture, counted apart
        runs = {}
        for name, graph in (("eager", False), ("graph", True)):
            P.RECORDER.clear()
            K2.note_step_cuda.launches = 0
            with monkeypatch.context() as m, profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                if not graph:
                    m.setattr(tst, "runs_as_graph", lambda *a: False)
                out = model(spec, decode_chunk=16)
            notes = [r for r in P.records(0, 2 ** 63)
                     if r.name == "decode/notes"]
            attn = sum(e.count for e in prof.key_averages()
                       if "attn_kernel(NoteStepArgs" in e.key)
            runs[name] = (out, notes, K2.note_step_cuda.launches, attn)
        P.RECORDER.clear()
    (want, _, _, _), (got, notes, launches, attn) = runs["eager"], \
        runs["graph"]
    for k in want[4]:
        assert torch.equal(got[4][k], want[4][k]), k
    for g, w in zip(got[:4], want[:4]):
        assert (g - w).abs().max().item() <= 1e-6
    assert len(notes) == cfg.max_bars
    steps = sum(span.counts["note_steps"] for span in notes)
    for span in notes:
        assert span.counts["graph_steps"] == span.counts["note_steps"] > 0
    assert launches == K2.STEP_LAUNCHES * steps + cfg.max_bars
    assert attn == steps
    _, eager_notes, eager_launches, eager_attn = runs["eager"]
    eager_steps = sum(span.counts["note_steps"] for span in eager_notes)
    assert eager_launches == K2.STEP_LAUNCHES * eager_steps + cfg.max_bars
    assert eager_attn == eager_steps


# Blocks of the race test: (rows, stop-group chunk, the lower staff's
# steps left before its cap where the block starts there (None: at step
# 0), whether an upper-staff pair stops inside the block).
RACE_CASES = {"16 rows, both staves": (16, None, None, False),
              "16 rows, lower cap in the block": (16, None, 6, False),
              "1 row": (1, None, None, False),
              "64 rows": (64, 16, None, False),
              "64 rows, a group stops in the block": (64, 16, None, True)}
RACE_REPLAYS = 50


def _race_block(p, cfg, enc, ep2, st):
    """(run, logp, pred): ``run(graph)`` restores the decode state ``st``
    as it is now (the prologue's query included) and runs one block of
    GRAPH_STEPS K2 steps from it, as a replay of ``graph`` or, where
    ``graph`` is None, as single steps with the card synchronised after
    each; it returns the state and outputs after the block, and the state
    before each single step."""
    B, steps = enc.shape[0], tst.GRAPH_STEPS
    logp = torch.empty((steps, 2, B, cfg.vocab_size), device=enc.device)
    pred = torch.empty((steps, 2, B), dtype=torch.long, device=enc.device)
    start = _snapshot(st)

    def block():
        for i in range(steps):
            tst._masked_step(p, cfg, enc, ep2, st, logp[i], pred[i])

    def run(graph):
        for k, v in start.items():
            getattr(st, k).copy_(v)
        logp.fill_(7.0)
        pred.fill_(-1)
        K2.note_step_prologue(p, st.work, st.h2)
        before = []
        if graph is None:
            for i in range(steps):
                torch.cuda.synchronize()
                before.append(_snapshot(st))
                tst._masked_step(p, cfg, enc, ep2, st, logp[i], pred[i])
        else:
            graph.replay()
        torch.cuda.synchronize()
        return dict(_snapshot(st), logp=logp.clone(), pred=pred.clone()), \
            before
    return run, block


def _capture(block, dev):
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        block()                                  # warm-up, as the decode
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with tst._workspaces_in_pool(), torch.cuda.graph(graph, stream=side):
        block()
    return graph


def _active_pairs(logp):
    """(steps, 2, B) bool: the rows each step computed (an inactive row's
    log-probs are all zero)."""
    return logp.abs().sum(dim=-1) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RACE_CASES))
def test_k2_replays_equal_synchronised_steps_on_the_card(card, case):
    """Each step's attention kernel starts before the step before it ends
    (programmatic dependent launch) and waits on it before it reads what it
    writes. A replayed block of GRAPH_STEPS steps must give, bit for bit,
    what the same steps give one at a time with the card synchronised after
    each,
    and the same bits on every one of RACE_REPLAYS replays from one state
    (K2 has no float atomics, so a read that races a write shows as a
    change); each step within the card's tolerance of the plain twin in
    float64 from the state K2 reached."""
    rows, chunk, lower_left, stops = RACE_CASES[case]
    cfg = tst.ModelConfig()
    t0 = cfg.max_length[1] - lower_left if lower_left else 0
    p, enc, ep2, h0 = _operands(cfg, rows, 1201, 11 + rows, torch.float32,
                                card, eos_bias=-20.0)   # nothing stops
    with torch.inference_mode():
        st = _state(p, cfg, enc, h0, chunk, "both")
        st.t.fill_(t0)
        if stops:
            # Every upper-staff group waits on one row: its pair stops at
            # that row's first <eos>.
            per = rows // st.groups
            st.done[0] = True
            st.done[0, ::per] = False
        run, block = _race_block(p, cfg, enc, ep2, st)
        if stops:
            # The upper <eos> raised until some pair stops in the block.
            base = p.b_out[0, cfg.eos].item()
            for raise_by in np.arange(20.5, 80.0, 0.5):
                p.b_out[0, cfg.eos] = base + raise_by
                on = _active_pairs(run(None)[0]["logp"])
                if (on[0, 0] & ~on[-1, 0]).any():
                    break
            assert (on[0, 0] & ~on[-1, 0]).any() and on[:, 1].all()
        single, before = run(None)
        graph = _capture(block, card)
        first, _ = run(graph)
        for k, want in single.items():
            assert torch.equal(first[k], want), k
        for r in range(RACE_REPLAYS):
            again, _ = run(graph)
            for k, want in first.items():
                assert torch.equal(again[k], want), (r, k)
    assert int(first["t"]) == t0 + tst.GRAPH_STEPS
    on = _active_pairs(first["logp"])
    if lower_left:
        assert on[:lower_left, 1].all() and not on[lower_left:, 1].any()

    p64 = tst.DualDecodeParams(**{k: v.double() for k, v in vars(p).items()})
    enc64, ep64 = enc.double(), ep2.double()
    for i, state in enumerate(before):
        s64 = {k: v.double() if v.is_floating_point() else v.clone()
               for k, v in state.items()}
        lp64 = torch.empty_like(first["logp"][i], dtype=torch.float64)
        pr64 = torch.empty_like(first["pred"][i])
        note_step_plain(p64, enc64, ep64, s64["h2"], s64["tok2"],
                        s64["lengths"], s64["done"], s64["t"], st.caps,
                        lp64, pr64, cfg.eos, st.groups)
        lp = first["logp"][i].double()
        tol = CARD_ULPS * max(1.0, lp64.abs().max().item())
        assert (lp - lp64).abs().max().item() <= tol, i
        assert torch.equal(_active_pairs(lp), _active_pairs(lp64)), i
        top2 = lp64.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > tol
        assert torch.equal(first["pred"][i][clear], pr64[clear]), i
        after = before[i + 1] if i + 1 < len(before) else first
        assert (after["h2"].double() - s64["h2"]).abs().max().item() <= 1e-5
