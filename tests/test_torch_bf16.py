"""The port's bfloat16 paths against the JAX package's on the CPU.

Serving: the greedy decode with ``decode_dtype`` (bf16 ConvStack and note
decoders, float32 softmaxes and log-probs), through ``forward`` and through
the Transcriber, and the transcribe command's ``--bf16``. Training: the
teacher-forced decode under ``decode_dtype`` and the ConvStack in mixed
precision (``conv_dtype``: bf16 convs and activations, float32 BatchNorm
statistics), through the train step, the Trainer (``train_dtype``) and
its uint8 staging.

Weights come from the JAX package's ``init_params`` through
``state_dict_from_jax``; inputs are made with numpy from seeds. The two
packages draw their dropout masks and teacher-forcing coins from different
generators, so parity runs patch both ``dropout``s to the identity and pin
tf to 1. bf16 rounds to 8 significant bits (an ulp of 2^-8 relative), and
the two packages round at different points (XLA fuses elementwise chains
in float32, PyTorch rounds after each op): log-probs are held within 0.05,
losses within 1e-2 relative.
"""

import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import piano_a2s_tpu.config as jconfig
import piano_a2s_tpu.train.harness as jharness
import piano_a2s_tpu_torch.config as tconfig
import piano_a2s_tpu_torch.data.datasets as tdata
import piano_a2s_tpu_torch.ops.layers as tL
import piano_a2s_tpu_torch.train.harness as tharness
from piano_a2s_tpu.infer import Transcriber as JaxTranscriber
from piano_a2s_tpu.models import ModelConfig, init_params, init_state
from piano_a2s_tpu.models import score_transcription as jst
from piano_a2s_tpu.ops.vqt import VQTConfig
from piano_a2s_tpu.train import step as jstep
from piano_a2s_tpu_torch import infer as tinfer
from piano_a2s_tpu_torch.cli import finetune as tfinetune
from piano_a2s_tpu_torch.cli import pretrain as tpretrain
from piano_a2s_tpu_torch.cli import transcribe as ttranscribe
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import state_dict_from_jax
from piano_a2s_tpu_torch.ops import vqt as tvqt
from piano_a2s_tpu_torch.train import step as tstep
from piano_a2s_tpu_torch.train.synthetic import write_clips
from piano_a2s_tpu_torch.utils.device import use_full_float32
from test_harness_e2e import _make_fixture
from test_torch_harness import CLI_YAML, _exp
from test_torch_train import no_dropout  # noqa: F401 (fixture)

torch.set_num_threads(2)

BF16 = torch.bfloat16
# Log-probs of the bf16 decode: against the JAX package's bf16 decode and
# against float32 (tests/test_bf16_decode.py's bound).
ATOL_LOGP = 0.05
# The train step's loss: against the JAX package's bf16 step, and against
# the float32 step (tests/test_bf16_train.py's bound).
RTOL_LOSS_JAX, RTOL_LOSS_F32 = 1e-2, 3e-2

# tests/test_bf16_decode.py's configuration.
CFG = ModelConfig(freq_bins=16, conv_feature_size=32, hidden_size=16,
                  max_bars=2, max_length=(8, 6), note_emb_size=8,
                  staff_emb_size=8)
# tests/test_bf16_train.py's configuration.
TRAIN_CFG = ModelConfig(freq_bins=16, conv_feature_size=24, hidden_size=16,
                        max_bars=2, max_length=(8, 6), note_emb_size=8,
                        staff_emb_size=8)
B, T_ENC = 4, 20


def _tcfg(cfg):
    return tst.ModelConfig(**{f: getattr(cfg, f) for f in
                              cfg.__dataclass_fields__})


def _params(cfg, seed, eos_bias=0.0):
    """JAX parameters and state as numpy, the staves' <eos> logit biased
    by ``eos_bias``."""
    params = jax.tree.map(np.array, init_params(jax.random.PRNGKey(seed),
                                                cfg))
    for d in ("upper", "lower"):
        params["decoder"][d]["out"]["b"][cfg.eos] += eos_bias
    return params, jax.tree.map(np.asarray, init_state(cfg))


def _port_model(cfg, params, state):
    model = tst.ScoreTranscription(_tcfg(cfg))
    model.load_state_dict(state_dict_from_jax(params, state, _tcfg(cfg)),
                          strict=True)
    return model


def test_full_float32_turns_off_bf16_reduced_precision_reduction(
        monkeypatch):
    monkeypatch.setattr(
        torch.backends.cuda.matmul,
        "allow_bf16_reduced_precision_reduction", True)
    use_full_float32()
    assert not torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


# --- the greedy decode -------------------------------------------------------

def _jax_greedy(params, state, spec, dtype):
    (ts, key, up, low, aux), _ = jst.forward(
        params, state, jnp.asarray(spec), jax.random.PRNGKey(0), cfg=CFG,
        train=False, decode_dtype=dtype)
    return [np.asarray(a) for a in (ts, key, up, low)], {
        k: np.asarray(v) for k, v in aux.items()}


def _port_greedy(model, spec, dtype):
    ts, key, up, low, aux = model(torch.from_numpy(spec), decode_dtype=dtype)
    return [a.numpy() for a in (ts, key, up, low)], {
        k: v.numpy() for k, v in aux.items()}


def _assert_same_decode(got, ref, atol, label):
    (g_outs, g_aux), (r_outs, r_aux) = got, ref
    for name, g, r in zip(("time_sig", "key"), g_outs[:2], r_outs[:2]):
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1),
                                      err_msg=name)
    for k in r_aux:
        np.testing.assert_array_equal(g_aux[k], r_aux[k], err_msg=k)
    worst = 0.0
    for name, g, r in zip(("upper", "lower"), g_outs[2:], r_outs[2:]):
        assert g.dtype == np.float32, name
        worst = max(worst, float(np.abs(g - r).max()))
        np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=name)
    print(f"{label}: max |log-prob difference| {worst:.3e} (atol {atol}), "
          f"lengths {r_aux['upper_lengths'].tolist()} "
          f"{r_aux['lower_lengths'].tolist()}")


@pytest.mark.parametrize("eos_bias,seed", [(6.0, 0), (0.0, 2)],
                         ids=["eos_confident", "free_running"])
def test_greedy_bf16_matches_jax_bf16(eos_bias, seed):
    """The port's bf16 decode against the JAX package's: equal time and
    key signatures, tokens and lengths; float32 log-probs within 0.05.
    eos_confident is tests/test_bf16_decode.py's model (+6 on <eos>);
    free_running (no bias) decodes every staff to its cap, so every step
    of the loop is held."""
    params, state = _params(CFG, seed, eos_bias)
    spec = np.random.RandomState(0).randn(2, 1, 20, 16).astype(np.float32)
    got = _port_greedy(_port_model(CFG, params, state), spec, BF16)
    ref = _jax_greedy(params, state, spec, jnp.bfloat16)
    _assert_same_decode(got, ref, ATOL_LOGP, "port bf16 vs JAX bf16")


def test_greedy_bf16_matches_f32_on_confident_model():
    params, state = _params(CFG, 0, 6.0)
    spec = np.random.RandomState(0).randn(2, 1, 20, 16).astype(np.float32)
    model = _port_model(CFG, params, state)
    _assert_same_decode(_port_greedy(model, spec, BF16),
                        _port_greedy(model, spec, None), ATOL_LOGP,
                        "port bf16 vs port f32")


def test_fast_step_keeps_softmax_and_log_softmax_float32(monkeypatch):
    """ROADMAP Queue 3's trap: on bf16 operands the decode step takes its
    attention softmax on float32 scores and its log-softmax on float32
    logits, and returns float32 log-probs (JAX score_transcription.py
    :599-601,615-616)."""
    params, state = _params(CFG, 0)
    dec = _port_model(CFG, params, state).decoder
    p = tst.dual_decode_params(dec.upper_decoder, dec.lower_decoder,
                               _tcfg(CFG), BF16)
    rng = np.random.RandomState(1)
    T, H = 20, CFG.hidden_size
    enc = torch.from_numpy(rng.randn(2, T, 2 * H).astype(np.float32)).to(BF16)
    enc_proj2 = torch.from_numpy(
        rng.randn(2, 2, T, H).astype(np.float32)).to(BF16)
    h2 = torch.from_numpy(rng.randn(2, 2, 2 * H).astype(np.float32)).to(BF16)
    tok2 = tst._tok_proj(p, torch.full((2, 2), CFG.sos))
    seen = []
    for name in ("softmax", "log_softmax"):
        orig = getattr(torch, name)

        def spy(x, *a, _name=name, _orig=orig, **k):
            seen.append((_name, x.dtype))
            return _orig(x, *a, **k)
        monkeypatch.setattr(torch, name, spy)
    h2_new, logp2, pred2 = tst._fast_step(p, enc, enc_proj2, h2, tok2)
    assert seen == [("softmax", torch.float32),
                    ("log_softmax", torch.float32)]
    assert h2_new.dtype == BF16 and logp2.dtype == torch.float32
    assert logp2.shape == (2, 2, CFG.vocab_size)
    torch.testing.assert_close(logp2.exp().sum(-1), torch.ones(2, 2))
    assert torch.equal(pred2, logp2.argmax(-1))


def test_folded_token_table_is_a_bf16_product_as_in_jax():
    """Cast first, then fold: the port's bf16 emb @ W_ih[token part] is
    JAX's emb_proj2 (a product of the bf16-cast stacked params) within one
    bf16 ulp; folding in float32 and casting after is not the same table."""
    params, state = _params(CFG, 0)
    dec = _port_model(CFG, params, state).decoder
    with torch.no_grad():
        got = tst.dual_decode_params(dec.upper_decoder, dec.lower_decoder,
                                     _tcfg(CFG), BF16).emb_proj
        folded_f32 = tst.dual_decode_params(
            dec.upper_decoder, dec.lower_decoder, _tcfg(CFG)).emb_proj
    dual = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                        jst.stack_staff_params(params["decoder"]["upper"],
                                               params["decoder"]["lower"]))
    E = CFG.note_emb_size
    ref = np.asarray(jnp.einsum("sve,sek->svk", dual["emb"]["emb"],
                                dual["gru"]["w_ih"][:, :E, :])
                     .astype(jnp.float32))
    assert got.dtype == BF16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp).all()
    assert not torch.equal(folded_f32.to(BF16).float(), torch.from_numpy(got))


# --- the Transcriber and the command -----------------------------------------

# tests/test_infer.py's configuration.
INFER_CFG = ModelConfig(freq_bins=12, conv_feature_size=16, hidden_size=16,
                        max_bars=2, max_length=(8, 6), note_emb_size=8,
                        staff_emb_size=8)
VQT = VQTConfig(bins_per_octave=3, n_octaves=4, window_size=1024,
                sample_rate=16000, hop_length=160)
TVQT = tvqt.VQTConfig(**{f: getattr(VQT, f) for f in
                         VQT.__dataclass_fields__})
FRAMES = 101


@pytest.mark.parametrize("eos_bias", [6.0, 0.0],
                         ids=["eos_confident", "free_running"])
def test_transcriber_bf16_matches_jax_bf16(eos_bias):
    params, state = _params(INFER_CFG, 0, eos_bias)
    jax_tr = JaxTranscriber(params, state, INFER_CFG, VQT,
                            max_frame_num=FRAMES, decode_dtype=jnp.bfloat16)
    port_tr = tinfer.Transcriber(
        state_dict_from_jax(params, state, _tcfg(INFER_CFG)),
        _tcfg(INFER_CFG), TVQT, max_frame_num=FRAMES, device="cpu",
        decode_dtype=BF16)
    rng = np.random.RandomState(1)
    clips = [(0.1 * rng.randn(n)).astype(np.float32)
             for n in (12000, 16000, 8000)]
    got = port_tr.transcribe_batch(clips)
    assert got == jax_tr.transcribe_batch(clips)
    # The confident model stops every staff at once; the free-running one
    # decodes tokens.
    assert any(len(staff) > 0 for bars in got for bar in bars
               for staff in bar[2:]) == (eos_bias == 0.0)


def test_decode_dtype_other_than_bf16_raises():
    sd = tst.ScoreTranscription(_tcfg(INFER_CFG)).state_dict()
    for bad in (torch.float16, torch.float32, "bfloat16"):
        with pytest.raises(ValueError, match="decode_dtype"):
            tinfer.Transcriber(sd, _tcfg(INFER_CFG), TVQT,
                               max_frame_num=FRAMES, device="cpu",
                               decode_dtype=bad)
    with pytest.raises(ValueError, match="decode_dtype"):
        tinfer.load_transcriber(None, _tcfg(INFER_CFG), TVQT,
                                max_frame_num=FRAMES, device="cpu",
                                decode_dtype=torch.float16)
    tr = tinfer.load_transcriber(None, _tcfg(INFER_CFG), TVQT,
                                 max_frame_num=FRAMES, device="cpu",
                                 decode_dtype=BF16)
    assert tr.decode_dtype == BF16
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())


def test_bf16_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinfer.load_transcriber(None, _tcfg(INFER_CFG), TVQT,
                                decode_dtype=BF16)
    clip = str(tmp_path / "clip.npy")
    np.save(clip, np.zeros(8000, np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttranscribe.main([clip, "--bf16", "--out-dir", str(tmp_path)])


def test_transcribe_command_bf16_on_cpu(tmp_path, monkeypatch, capsys):
    """cli.transcribe --bf16 --device cpu: the Transcriber it builds
    decodes in bf16, and the clip becomes score files."""
    built = []
    load = tinfer.load_transcriber

    def spy(*args, **kwargs):
        built.append(load(*args, **kwargs))
        return built[-1]
    monkeypatch.setattr(tinfer, "load_transcriber", spy)
    yaml_path = str(tmp_path / "tiny.yaml")
    with open(yaml_path, "w") as f:
        f.write("max_length: [8, 6]\nmax_bars: 2\nmax_duration: 1\n"
                "frames_per_second: 23\nbins_per_octave: 4\nn_octaves: 4\n"
                "conv_feature_size: 16\nhidden_size: 16\nnote_emb_size: 8\n"
                "staff_emb_size: 8\n")
    clip = str(tmp_path / "clip.npy")
    np.save(clip, (0.1 * np.random.RandomState(0).randn(8000))
            .astype(np.float32))
    out = str(tmp_path / "out")
    assert ttranscribe.main([clip, "--bf16", "--device", "cpu", "--config",
                             yaml_path, "--out-dir", out]) == 0
    assert built[0].decode_dtype == BF16
    assert sorted(os.listdir(out)) == ["clip.krn", "clip.mid", "clip.xml"]
    assert "transcribed 1 clip(s)" in capsys.readouterr().out


# --- the teacher-forced decode -----------------------------------------------

def _gt_batch(cfg, b, seed):
    """tests/test_bf16_train.py's batch: a spectrogram, random targets of
    random lengths, <pad> after each length (no EOS)."""
    rng = np.random.RandomState(seed)
    batch = {
        "spectrogram": rng.randn(b, 1, T_ENC, cfg.freq_bins)
        .astype(np.float32),
        "time_sig": rng.randint(0, 7, (b, cfg.max_bars)),
        "key": rng.randint(0, 14, (b, cfg.max_bars)),
        "upper": rng.randint(0, 140, (b, cfg.max_bars, cfg.max_length[0])),
        "upper_lengths": rng.randint(2, cfg.max_length[0],
                                     (b, cfg.max_bars)),
        "lower": rng.randint(0, 140, (b, cfg.max_bars, cfg.max_length[1])),
        "lower_lengths": rng.randint(2, cfg.max_length[1],
                                     (b, cfg.max_bars)),
    }
    for staff, cap in (("upper", cfg.max_length[0]),
                       ("lower", cfg.max_length[1])):
        toks, lens = batch[staff], batch[f"{staff}_lengths"]
        pos = np.arange(cap)
        toks[pos[None, None, :] >= lens[..., None]] = cfg.pad
    return batch


def _gt(batch):
    return tuple(batch[k] for k in ("time_sig", "key", "upper",
                                    "upper_lengths", "lower",
                                    "lower_lengths"))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_teacher_forced_bf16_decode_matches_jax(no_dropout, train):
    """tests/test_bf16_decode.py's teacher-forced run (tf 1.0) in both
    packages: float32, finite log-probs within 0.05 of each other."""
    params, state = _params(CFG, 1)
    batch = _gt_batch(CFG, 2, 0)
    (ts, key, up, low, _), _ = jst.forward(
        params, state, jnp.asarray(batch["spectrogram"]),
        jax.random.PRNGKey(0), cfg=CFG, train=train,
        ground_truth=tuple(map(jnp.asarray, _gt(batch))), tf_ratio=1.0,
        decode_dtype=jnp.bfloat16)
    model = _port_model(CFG, params, state)
    outs = model(torch.from_numpy(batch["spectrogram"]), train=train,
                 ground_truth=tuple(map(torch.from_numpy, _gt(batch))),
                 tf_ratio=1.0, decode_dtype=BF16,
                 generator=torch.Generator().manual_seed(0))
    worst = 0.0
    for name, got, ref in zip(("time_sig", "key", "upper", "lower"), outs[:4],
                              (ts, key, up, low)):
        got, ref = got.detach().numpy(), np.asarray(ref)
        assert got.dtype == np.float32 and np.isfinite(got).all(), name
        worst = max(worst, float(np.abs(got - ref).max()))
        np.testing.assert_allclose(got, ref, atol=ATOL_LOGP, rtol=0,
                                   err_msg=name)
    print(f"teacher-forced bf16 decode, port vs JAX: max |log-prob "
          f"difference| {worst:.3e} (atol {ATOL_LOGP})")
    if train:  # the float32 parameters get gradients through the casts
        outs[2].sum().backward()
        w = model.decoder.upper_decoder.gru.weight_hh_l0
        assert w.grad is not None and w.grad.dtype == torch.float32
        assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0


# --- the bf16 ConvStack: BatchNorm + ReLU, saved activations -----------------

@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float64, BF16], ids=["f64", "bf16"])
@pytest.mark.parametrize("axes,shape", [((0, 2, 3), (4, 5, 6, 7)),
                                        ((0, 1), (4, 6, 5))],
                         ids=["conv", "linear"])
def test_batch_norm_relu_equals_straight_line(axes, shape, dtype, weighted):
    """batch_norm_relu_train against relu(batch_norm_train(x in f32 or
    wider) cast back), under autograd: the same output, running statistics
    and (to rounding) gradients."""
    torch.manual_seed(0)
    fdt = tL.float32_or_wider(dtype)
    channels = [n for i, n in enumerate(shape) if i not in axes][0]
    bns = [torch.nn.BatchNorm1d(channels).to(fdt) for _ in range(2)]
    with torch.no_grad():
        bns[0].weight.uniform_(0.5, 1.5)
        bns[0].bias.uniform_(-0.5, 0.5)
    bns[1].load_state_dict(bns[0].state_dict())
    x = (2.0 * torch.randn(shape, dtype=torch.float64) + 0.3).to(dtype)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    w = torch.tensor([1.0, 0.0, 1.0, 1.0]) if weighted else None
    g = torch.randn(shape, dtype=torch.float64).to(dtype)
    got = tL.batch_norm_relu_train(xs[0], bns[0], axes, w)
    # The JAX package's order: BatchNorm in f, cast, then the ReLU.
    ref = torch.relu(tL.batch_norm_train(
        xs[1].to(fdt), bns[1], axes, None if w is None else w.to(fdt)
    ).to(dtype))
    assert got.dtype == dtype and torch.equal(got, ref)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(bns[0], name), getattr(bns[1], name))
    (got.to(fdt) * g.to(fdt)).sum().backward()
    (ref.to(fdt) * g.to(fdt)).sum().backward()
    # f64: the same gradient to rounding; bf16: dx is rounded to bf16 once
    # from the float32 value in both, the parameters' gradients are f32.
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == torch.float64 else \
        dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xs[0].grad.to(fdt), xs[1].grad.to(fdt), **tol)
    for a, b in ((bns[0].weight, bns[1].weight), (bns[0].bias, bns[1].bias)):
        assert a.grad.dtype == fdt
        torch.testing.assert_close(a.grad, b.grad, **tol)


def _saved_by_convstack(compute_dtype):
    """(dtype, numel) of every tensor autograd saves over the train-mode
    ConvStack forward at TRAIN_CFG's width, batch B."""
    torch.manual_seed(0)
    convstack = tst.ConvStack(_tcfg(TRAIN_CFG))
    x = torch.randn(B, 1, T_ENC, TRAIN_CFG.freq_bins)
    saved = []

    def pack(t):
        saved.append((t.dtype, t.numel()))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = convstack.forward_train(x, torch.ones(B),
                                    torch.Generator().manual_seed(0),
                                    compute_dtype)
    y.float().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in convstack.parameters())
    return saved


def test_bf16_convstack_saves_only_bf16_activations():
    """Every floating tensor autograd keeps at activation size (at least
    the spectrogram's B x T x F elements) is bf16 under conv_dtype; the
    float32 ConvStack keeps float32 ones, more than twice the bytes."""
    act = B * T_ENC * TRAIN_CFG.freq_bins
    big = {}
    for dt in (None, BF16):
        big[dt] = [(d, n) for d, n in _saved_by_convstack(dt)
                   if d.is_floating_point and n >= act]
    assert big[BF16] and all(d == BF16 for d, _ in big[BF16])
    assert big[None] and all(d == torch.float32 for d, _ in big[None])
    nbytes = {dt: sum(n * (2 if d == BF16 else 4) for d, n in v)
              for dt, v in big.items()}
    assert nbytes[BF16] * 2 < nbytes[None], nbytes


# --- the bf16 train step -----------------------------------------------------

def _train_batch(seed=0, b=B):
    return _gt_batch(TRAIN_CFG, b, seed)


def _jax_bf16_step_loss(params, state, batch):
    opt = jstep.make_optimizer(lr=1.0)
    t_step, _ = jstep.make_jitted_steps(opt, TRAIN_CFG,
                                        conv_dtype=jnp.bfloat16)
    *_, out = t_step(jax.tree.map(jnp.asarray, params), opt.init(params),
                     jax.tree.map(jnp.asarray, state),
                     {k: jnp.asarray(v) for k, v in batch.items()},
                     jax.random.PRNGKey(1), 1.0)
    return float(out.loss)


def _port_step(params, state, conv_dtype, accum_steps=1):
    model = _port_model(TRAIN_CFG, params, state)
    optimizer = tstep.make_optimizer(model.parameters())
    t_step, _ = tstep.make_train_steps(optimizer, accum_steps=accum_steps,
                                       conv_dtype=conv_dtype, device="cpu")
    return model, optimizer, t_step


def _flat(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def test_bf16_train_step_matches_jax_and_f32(no_dropout):
    """One conv_dtype=bf16 step: its loss within 1e-2 of the JAX package's
    bf16 step and 3e-2 of the port's float32 step; the parameters, BN
    buffers and Adadelta state stay float32; the update's norm is within
    20% of the float32 step's."""
    params, state = _params(TRAIN_CFG, 0)
    batch = _train_batch()
    loss_j = _jax_bf16_step_loss(params, state, batch)
    gen = torch.Generator().manual_seed(0)
    runs = {}
    for dt in (None, BF16):
        model, optimizer, t_step = _port_step(params, state, dt)
        before = _flat(model)
        out = t_step(model, batch, gen, 1.0)
        runs[dt] = (float(out.loss), _flat(model) - before, model, optimizer)
    loss_bf, delta_bf, model, optimizer = runs[BF16]
    loss_32, delta_32 = runs[None][:2]
    print(f"bf16 step loss: port {loss_bf:.6f}, JAX {loss_j:.6f}, port f32 "
          f"{loss_32:.6f}")
    np.testing.assert_allclose(loss_bf, loss_j, rtol=RTOL_LOSS_JAX)
    np.testing.assert_allclose(loss_bf, loss_32, rtol=RTOL_LOSS_F32)
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        assert t.dtype == torch.float32 or not t.is_floating_point(), name
    for s in optimizer.state.values():
        for k in ("square_avg", "acc_delta"):
            assert s[k].dtype == torch.float32, k
    assert torch.isfinite(delta_bf).all()
    assert float(delta_bf.norm()) == pytest.approx(float(delta_32.norm()),
                                                   rel=0.2)
    bn = model.convstack.bn1.running_mean
    assert not torch.equal(bn, torch.zeros_like(bn))


def test_bf16_loss_decreases_over_steps():
    params, state = _params(TRAIN_CFG, 0)
    batch = _train_batch()
    model, _, t_step = _port_step(params, state, BF16)
    gen = torch.Generator().manual_seed(10)
    losses = [float(t_step(model, batch, gen, 1.0).loss) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_bf16_composes_with_accumulation():
    params, state = _params(TRAIN_CFG, 0)
    model, _, t_step = _port_step(params, state, BF16, accum_steps=2)
    before = _flat(model)
    out = t_step(model, _train_batch(), torch.Generator().manual_seed(2),
                 0.7)
    assert np.isfinite(float(out.loss))
    assert not torch.equal(_flat(model), before)
    for t in model.buffers():
        assert t.dtype == torch.float32 or not t.is_floating_point()


def test_u8_staged_batch_matches_f32_upload_of_its_values():
    """uint8 staging under bf16 training: the u8 batch's loss equals that
    of the float32 upload of the dequantized values (the same math)."""
    rng = np.random.RandomState(3)
    batch = _train_batch()
    spec = rng.rand(*batch["spectrogram"].shape).astype(np.float32)
    q = np.round(spec * 255.0).astype(np.uint8)
    params, state = _params(TRAIN_CFG, 0)
    losses = {}
    for tag, s in (("u8", q), ("deq", q.astype(np.float32) / 255.0)):
        model, _, t_step = _port_step(params, state, BF16)
        losses[tag] = float(t_step(model, dict(batch, spectrogram=s),
                                   torch.Generator().manual_seed(1),
                                   1.0).loss)
    np.testing.assert_allclose(losses["u8"], losses["deq"], rtol=1e-6)


# --- the Trainer -------------------------------------------------------------

# tests/test_bf16_train.py::test_harness_staging_dtype_selection's cases.
STAGING_CASES = [
    {"train_dtype": "bfloat16"},
    {"train_dtype": "bfloat16", "upload_dtype": "float16"},
    {"train_dtype": "bfloat16", "upload_f16": True},
    {"train_dtype": "bfloat16", "upload_f16": False},
    {},
    {"train_dtype": "bf16", "input_features": "audio"},
]


@pytest.mark.parametrize("extras", STAGING_CASES,
                         ids=lambda e: ",".join(f"{k}={v}"
                                                for k, v in e.items())
                         or "defaults")
def test_trainer_staging_dtype_as_jax(tmp_path, extras):
    root = str(tmp_path)
    jtr = jharness.Trainer(_exp(jconfig, root, root, "j", **extras))
    ttr = tharness.Trainer(_exp(tconfig, root, root, "t", **extras),
                           device="cpu")
    assert ttr.upload_dtype == jtr.upload_dtype
    assert (ttr.conv_dtype == BF16) == (jtr.conv_dtype == jnp.bfloat16)
    batch = _train_batch(b=2)
    batch = dict(batch, names=["a", "b"], versions=[0, 0],
                 audio=np.zeros((2, 160), np.float32))
    for train in (True, False):
        got = ttr._device_batch(batch, train=train)[ttr.feature_key]
        ref = jtr._device_batch(batch, train=train)[jtr.feature_key]
        assert got.dtype == ref.dtype, (train, got.dtype, ref.dtype)


@pytest.mark.parametrize("extras", [
    {"train_dtype": "int8"}, {"train_dtype": "float16"},
    {"train_dtype": "bfloat16", "upload_dtype": "int4"}])
def test_trainer_rejects_what_jax_rejects(tmp_path, extras):
    root = str(tmp_path)
    with pytest.raises(ValueError):
        jharness.Trainer(_exp(jconfig, root, root, "j", **extras))
    with pytest.raises(ValueError):
        tharness.Trainer(_exp(tconfig, root, root, "t", **extras),
                         device="cpu")


def test_trainer_bf16_fits_an_epoch_on_uint8_batches(tmp_path):
    features = str(tmp_path / "features")
    _make_fixture(features, "train", 0)
    _make_fixture(features, "valid", 0, n_songs=2, seed=1)
    exp = _exp(tconfig, str(tmp_path), features, "t", train_dtype="bfloat16")
    trainer = tharness.Trainer(exp, device="cpu")
    assert trainer.conv_dtype == BF16 and trainer.upload_dtype == np.uint8
    kw = dict(max_frame_num=exp.max_frame_num, max_length=exp.max_length)
    train_loader = tdata.DataLoader(
        tdata.SyntheticTrainDataset(features, "train", versions=[0],
                                    rng=np.random.RandomState(0), **kw),
        2, shuffle=True, seed=0)
    valid = tdata.DataLoader(
        tdata.SyntheticTestDataset(features, "valid", versions=[0], **kw), 2)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.fit(train_loader, valid, epochs=1)
    assert np.isfinite(trainer.train_stats["loss"])
    assert train_loader.transform is not None
    assert next(iter(train_loader))["spectrogram"].dtype == np.uint8
    after = trainer.model.state_dict()
    assert all(v.dtype == before[k].dtype for k, v in after.items())
    assert not torch.equal(after["convstack.conv1.weight"],
                           before["convstack.conv1.weight"])


@pytest.mark.parametrize("command", ["pretrain", "finetune"])
def test_train_commands_train_in_bf16_from_an_override(tmp_path, monkeypatch,
                                                       command):
    """train_dtype=bfloat16 on the pretrain or finetune command line
    reaches the Trainer: its one train step runs the bf16 ConvStack."""
    root = str(tmp_path)
    kw = dict(samples=(2500, 3800), upper=(1, 7), lower=(1, 5), bars=2)
    for split in ("train", "valid", "test"):
        write_clips(os.path.join(root, "synth", split, "0"), 2,
                    seed=len(split), **kw)
    for split in ("train", "test"):
        write_clips(os.path.join(root, "asap", split), 2, seed=9, **kw)
    yaml_path = str(tmp_path / "tiny.yaml")
    with open(yaml_path, "w") as f:
        f.write(CLI_YAML.format(root=root))
    seen = []
    forward_train = tst.ConvStack.forward_train

    def spy(self, x, *args, **kwargs):
        seen.append(inspect.signature(forward_train).bind(
            self, x, *args, **kwargs).arguments.get("compute_dtype"))
        return forward_train(self, x, *args, **kwargs)
    monkeypatch.setattr(tst.ConvStack, "forward_train", spy)
    cli = {"pretrain": tpretrain, "finetune": tfinetune}[command]
    corpus = {"pretrain": "synth", "finetune": "asap"}[command]
    assert cli.main([yaml_path, f"version={command}", f"corpus={corpus}",
                     "number_of_epochs=1", "train_dtype=bfloat16",
                     "--device", "cpu"]) == 0
    assert seen == [BF16]
    assert "train_dtype: bfloat16" in open(
        os.path.join(root, command, "hyperparams.yaml")).read()
