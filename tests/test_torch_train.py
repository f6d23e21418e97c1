"""The port's training slice against the JAX package on the CPU.

The same weights (moved across by ``state_dict_from_jax``) and the same
inputs (made with numpy from seeds) go through both. The two draw their
dropout masks and teacher-forcing coins from different generators, so the
parity tests pin tf to 0 or 1 (the coins are then certain) and, in train
mode, patch both packages' ``dropout`` to the identity. Comparisons are in
float64 at atol 1e-8 unless a test says otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import piano_a2s_tpu.ops.layers as jL
import piano_a2s_tpu_torch.ops.layers as tL
from piano_a2s_tpu.models import ModelConfig, forward, init_params, init_state
from piano_a2s_tpu.models import score_transcription as jst
from piano_a2s_tpu.train import losses as jlosses
from piano_a2s_tpu.train import step as jstep
from piano_a2s_tpu.train.harness import _duration_fraction_table
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import state_dict_from_jax
from piano_a2s_tpu_torch.ops.vqt import VQTConfig as TVQTConfig
from piano_a2s_tpu_torch.ops.vqt import get_vqt as t_get_vqt
from piano_a2s_tpu_torch.train import losses as tlosses
from piano_a2s_tpu_torch.train import step as tstep
from test_torch_teacher_graph import unrolled_bar

torch.set_num_threads(2)

# tests/test_gradient_parity.py's small configuration.
CFG = ModelConfig(freq_bins=24, conv_feature_size=32, hidden_size=24,
                  max_bars=2, max_length=(10, 7), note_emb_size=8,
                  staff_emb_size=8, time_sig_emb_size=5, key_emb_size=8)
TCFG = tst.ModelConfig(**{f: getattr(CFG, f) for f in
                          CFG.__dataclass_fields__})
T_SPEC = 30
ATOL = 1e-8
# The JAX package computes the guided-attention penalty in float32 even
# under x64 (score_transcription.py:530-535), and so does the port, each
# with its own float32 sums: the penalty sums (~1-10) and the ga loss
# (~0.7) differ by a few float32 ulps (eps 1.2e-7). Their gradients reach
# the float64 parameters through the float32 guide, which is elementwise,
# and stay within ATOL.
ATOL_GA = 1e-6


@pytest.fixture(scope="module")
def x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(jL, "dropout", lambda key, x, rate, train: x)
    monkeypatch.setattr(tL, "dropout",
                        lambda x, rate, train, generator=None: x)


def _batch(b=2, seed=3, events=False):
    """Spectrogram and well-formed targets: each staff's tokens, then EOS,
    then <pad>; lengths exclude the EOS and are at least 1."""
    rng = np.random.RandomState(seed)
    vocab = np.arange(140)
    if events:  # real-pipeline shape: events separated by '\n'
        vocab = np.concatenate([vocab, np.full(40, CFG.newline)])

    def staff(cap):
        tok = np.full((b, CFG.max_bars, cap), CFG.pad, np.int64)
        lens = np.zeros((b, CFG.max_bars), np.int64)
        for i in range(b):
            for m in range(CFG.max_bars):
                n = rng.randint(1, cap - 1)
                tok[i, m, :n] = rng.choice(vocab, n)
                tok[i, m, n] = CFG.eos
                lens[i, m] = n
        return tok, lens

    up, up_len = staff(CFG.max_length[0])
    low, low_len = staff(CFG.max_length[1])
    return {"spectrogram": rng.randn(b, 1, T_SPEC, CFG.freq_bins),
            "time_sig": rng.randint(0, CFG.num_time_sig, (b, CFG.max_bars)),
            "key": rng.randint(0, CFG.num_keys, (b, CFG.max_bars)),
            "upper": up, "upper_lengths": up_len,
            "lower": low, "lower_lengths": low_len}


def _gt(batch, convert):
    """The forward's ground-truth tuple, each array through ``convert``."""
    return tuple(convert(np.asarray(batch[k]))
                 for k in ("time_sig", "key", "upper", "upper_lengths",
                           "lower", "lower_lengths"))


def _weights(nudge_state=0.0):
    params = jax.tree.map(lambda x: np.array(x, np.float64),
                          init_params(jax.random.PRNGKey(11), CFG))
    state = jax.tree.map(lambda x: np.array(x, np.float64) + nudge_state,
                         init_state(CFG))
    return params, state


def _port_model(params, state):
    model = tst.ScoreTranscription(TCFG).double()
    model.load_state_dict(state_dict_from_jax(params, state, TCFG),
                          strict=True)
    return model


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_grads(model, grads_jax, atol=ATOL):
    zero_state = jax.tree.map(np.zeros_like, init_state(CFG))
    ref = state_dict_from_jax(jax.tree.map(np.asarray, grads_jax),
                              zero_state, TCFG)
    n = 0
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)
        n += 1
    assert n > 50  # every parameter tensor


def _assert_bn_state(model, state_jax, atol=ATOL):
    sd = model.state_dict()
    cs = state_jax["convstack"]
    for name in ("bn1", "bn2", "bn3", "bn4", "out_bn"):
        for jk, tk in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                sd[f"convstack.{name}.{tk}"].numpy(),
                np.asarray(cs[name][jk]), atol=atol, rtol=0,
                err_msg=f"{name}.{tk}")


def _assert_params(model, params_jax, atol=ATOL):
    zero_state = jax.tree.map(np.zeros_like, init_state(CFG))
    ref = state_dict_from_jax(jax.tree.map(np.asarray, params_jax),
                              zero_state, TCFG)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def _assert_comps(comps_t, comps_j, atol=ATOL):
    assert sorted(comps_t) == sorted(comps_j)
    for k in comps_j:
        np.testing.assert_allclose(float(comps_t[k]), float(comps_j[k]),
                                   atol=atol, rtol=0, err_msg=k)


def _jax_loss_and_grads(params, state, batch, train, tf, emit_full=False,
                        sample_weight=None, ga_weight=0.0, ga_dur_frac=None,
                        ga_content=None, ga_map="auto"):
    tbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        outs, new_state = forward(
            p, state, tbatch["spectrogram"], jax.random.PRNGKey(0), cfg=CFG,
            train=train, ground_truth=_gt(batch, jnp.asarray), tf_ratio=tf,
            emit_full=emit_full, sample_weight=sample_weight,
            ga_sigma=0.15 if ga_weight else 0.0, ga_dur_frac=ga_dur_frac,
            ga_content=ga_content, ga_map=ga_map)
        if emit_full:
            loss, comps = jlosses.transcription_loss(
                outs, tbatch, CFG.pad, sample_weight=sample_weight)
        else:
            loss, comps = jlosses.transcription_loss_fused(
                outs, tbatch, CFG.pad, sample_weight=sample_weight,
                ga_weight=ga_weight)
        return loss, (comps, new_state, outs[4])

    (loss, (comps, new_state, aux)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), comps, new_state, aux, grads


def _port_loss_and_grads(model, batch, train, tf, emit_full=False,
                         sample_weight=None, ga_weight=0.0, ga_dur_frac=None,
                         ga_content=None, ga_map="auto"):
    tb = _tensors(batch)
    sw = None if sample_weight is None else torch.from_numpy(sample_weight)
    gc = None if ga_content is None else torch.from_numpy(ga_content)
    outs = model(tb["spectrogram"], train=train, ground_truth=_gt(batch, torch.from_numpy),
                 tf_ratio=tf, emit_full=emit_full, sample_weight=sw,
                 ga_sigma=0.15 if ga_weight else 0.0, ga_dur_frac=ga_dur_frac,
                 ga_content=gc, ga_map=ga_map,
                 generator=torch.Generator().manual_seed(0))
    if emit_full:
        loss, comps = tlosses.transcription_loss(outs, tb, CFG.pad,
                                                 sample_weight=sw)
    else:
        loss, comps = tlosses.transcription_loss_fused(
            outs, tb, CFG.pad, sample_weight=sw, ga_weight=ga_weight)
    loss.backward()
    return (float(loss.detach()), {k: v.detach() for k, v in comps.items()},
            {k: v.detach() for k, v in outs[4].items()})


# --- the forward and its gradients -----------------------------------------

@pytest.mark.parametrize("emit_full", [False, True], ids=["fused", "full"])
@pytest.mark.parametrize("tf", [0.0, 1.0])
def test_teacher_forced_eval_mode_parity(x64, tf, emit_full):
    """train=False with ground truth (the form of
    tests/test_gradient_parity.py): BN folded, no dropout, coins certain."""
    params, state = _weights(nudge_state=0.05)
    batch = _batch()
    batch["spectrogram"] = 10.0 * batch["spectrogram"]
    loss_j, comps_j, _, aux_j, grads_j = _jax_loss_and_grads(
        params, state, batch, False, tf, emit_full=emit_full)
    model = _port_model(params, state)
    loss_t, comps_t, aux_t = _port_loss_and_grads(model, batch, False, tf,
                                                  emit_full=emit_full)
    np.testing.assert_allclose(loss_t, loss_j, atol=ATOL, rtol=0)
    _assert_comps(comps_t, comps_j)
    for k in ("upper_tokens", "lower_tokens", "upper_lengths",
              "lower_lengths"):
        np.testing.assert_array_equal(aux_t[k].numpy(), np.asarray(aux_j[k]),
                                      err_msg=k)
    _assert_grads(model, grads_j)


@pytest.mark.parametrize("weights", [None, [1.0, 0.0, 1.0, 1.0],
                                     [0.0, 0.0, 0.0, 0.0]],
                         ids=["unweighted", "weighted", "all_zero"])
def test_train_mode_parity(x64, no_dropout, weights):
    """train=True: BN on (weighted) batch statistics and its running
    statistics; an all-zero weight falls back to unweighted statistics."""
    params, state = _weights()
    batch = _batch(b=4, seed=7)
    sw = None if weights is None else np.asarray(weights, np.float64)
    loss_j, comps_j, state_j, _, grads_j = _jax_loss_and_grads(
        params, state, batch, True, 1.0, sample_weight=sw)
    model = _port_model(params, state)
    loss_t, comps_t, _ = _port_loss_and_grads(model, batch, True, 1.0,
                                              sample_weight=sw)
    assert np.isfinite(loss_t)
    np.testing.assert_allclose(loss_t, loss_j, atol=ATOL, rtol=0)
    _assert_comps(comps_t, comps_j)
    _assert_grads(model, grads_j)
    _assert_bn_state(model, state_j)
    assert not np.allclose(state_j["convstack"]["bn1"]["mean"],
                           state["convstack"]["bn1"]["mean"])


@pytest.mark.parametrize("ga_map,dur,content", [
    ("auto", True, True), ("events", True, False), ("tokens", True, True),
    ("auto", False, False)],
    ids=["auto_content", "events", "tokens_content", "token_index"])
def test_guided_attention_parity(x64, no_dropout, ga_map, dur, content):
    params, state = _weights()
    batch = _batch(b=2, seed=5, events=True)
    table = _duration_fraction_table(CFG.vocab_size) if dur else None
    gc = (np.asarray([0.9, 0.6], np.float32) if content else None)
    kw = dict(ga_weight=1.0, ga_dur_frac=table, ga_content=gc, ga_map=ga_map)
    loss_j, comps_j, _, aux_j, grads_j = _jax_loss_and_grads(
        params, state, batch, True, 1.0, **kw)
    model = _port_model(params, state)
    loss_t, comps_t, aux_t = _port_loss_and_grads(model, batch, True, 1.0,
                                                  **kw)
    assert comps_t["ga_loss"] > 0
    np.testing.assert_allclose(aux_t["ga_num"].numpy(),
                               np.asarray(aux_j["ga_num"]), atol=ATOL_GA,
                               rtol=0)
    np.testing.assert_allclose(loss_t, loss_j, atol=ATOL_GA, rtol=0)
    _assert_comps({k: v for k, v in comps_t.items() if k != "ga_loss"},
                  {k: v for k, v in comps_j.items() if k != "ga_loss"})
    _assert_comps(comps_t, comps_j, atol=ATOL_GA)
    _assert_grads(model, grads_j)


def test_checkpointed_decode_draws_the_same_masks(monkeypatch):
    """The teacher-forced decode's recompute (``_TeacherBar``'s backward
    sweep) changes nothing, with dropout on: it sees the masks and coins
    drawn outside it. Held against the plain unrolled loop of the same
    steps: the loss exactly, every gradient within 1e-12 of its largest
    entry (the sweep sums a bar's parts of a leaf before autograd adds the
    bars, the unrolled loop all of them in one buffer: float64 rounding,
    3.5e-15 at most in tests/test_torch_teacher_graph.py)."""
    params, state = _weights()
    batch = _batch(b=2, seed=9)
    losses, grads = [], []
    for swept in (True, False):
        if not swept:
            monkeypatch.setattr(tst._TeacherBar, "apply", unrolled_bar)
        model = _port_model(params, state)
        losses.append(_port_loss_and_grads(model, batch, True, 0.5)[0])
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert losses[0] == losses[1]
    for n in grads[0]:
        scale = float(grads[1][n].abs().max())
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=0,
                                   atol=1e-12 * scale, msg=n)


# --- the optimizer step ------------------------------------------------------

def _jax_opt_state_dict(opt_state, key):
    inner = opt_state.inner_state[1]
    tree = inner.e_g if key == "square_avg" else inner.e_x
    zero_state = jax.tree.map(np.zeros_like, init_state(CFG))
    return state_dict_from_jax(jax.tree.map(np.asarray, tree), zero_state,
                               TCFG)


def _assert_opt_state(model, optimizer, opt_state_j):
    for key in ("square_avg", "acc_delta"):
        ref = _jax_opt_state_dict(opt_state_j, key)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(
                optimizer.state[p][key].numpy(), ref[name].numpy(),
                atol=ATOL, rtol=0, err_msg=f"{name} {key}")


def test_train_step_parity(x64, no_dropout):
    """Three train_steps against the JAX package's: the loss, every
    parameter, the Adadelta state and the BN state after each step."""
    params, state = _weights()
    opt = jstep.make_optimizer(lr=1.0)
    opt_state = opt.init(params)
    j_step = jax.jit(lambda p, o, s, b: jstep.train_step(
        p, o, s, b, jax.random.PRNGKey(0), 1.0, optimizer=opt, cfg=CFG))
    model = _port_model(params, state)
    optimizer = tstep.make_optimizer(model.parameters())
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        batch = _batch(b=2, seed=20 + i)
        params, opt_state, state, out_j = j_step(
            params, opt_state, state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        out_t = tstep.train_step(model, optimizer, _tensors(batch), gen, 1.0)
        np.testing.assert_allclose(float(out_t.loss), float(out_j.loss),
                                   atol=ATOL, rtol=0)
        _assert_comps(out_t.components, out_j.components)
        _assert_params(model, params)
        _assert_opt_state(model, optimizer, opt_state)
        _assert_bn_state(model, state)


def test_train_step_nonfinite_changes_nothing(x64):
    params, state = _weights()
    model = _port_model(params, state)
    optimizer = tstep.make_optimizer(model.parameters())
    gen = torch.Generator().manual_seed(0)
    tstep.train_step(model, optimizer, _tensors(_batch(seed=1)), gen, 0.7)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = {id(p): {k: v.clone() for k, v in s.items()}
                  for p, s in optimizer.state.items()}
    batch = _batch(seed=2)
    batch["spectrogram"][0, 0, 3, 4] = np.nan
    out = tstep.train_step(model, optimizer, _tensors(batch), gen, 0.7)
    assert not np.isfinite(float(out.loss))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    for p, s in optimizer.state.items():
        for k, v in s.items():
            torch.testing.assert_close(v, opt_before[id(p)][k], rtol=0,
                                       atol=0)


def test_train_step_accum_parity(x64, no_dropout):
    """accum_steps=2 against the JAX package's train_step_accum: BN
    running statistics from microbatch 0 only."""
    params, state = _weights()
    batch = _batch(b=4, seed=11)
    batch["sample_weight"] = np.asarray([1.0, 1.0, 0.0, 1.0])
    opt = jstep.make_optimizer(lr=1.0)
    p_j, o_j, s_j, out_j = jax.jit(lambda p, o, s, b: jstep.train_step_accum(
        p, o, s, b, jax.random.PRNGKey(0), 1.0, optimizer=opt, cfg=CFG,
        accum_steps=2))(params, opt.init(params), state,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(params, state)
    optimizer = tstep.make_optimizer(model.parameters())
    out_t = tstep.train_step_accum(model, optimizer, _tensors(batch),
                                   torch.Generator().manual_seed(0), 1.0,
                                   accum_steps=2)
    np.testing.assert_allclose(float(out_t.loss), float(out_j.loss),
                               atol=ATOL, rtol=0)
    _assert_comps(out_t.components, out_j.components)
    _assert_params(model, p_j)
    _assert_opt_state(model, optimizer, o_j)
    _assert_bn_state(model, s_j)


def test_accum_equals_monolithic_on_duplicated_microbatches(no_dropout):
    """A batch whose second half repeats the first: each microbatch has the
    whole batch's BN statistics, so with tf=1 and no dropout the
    accumulated step equals the monolithic one (as
    tests/test_grad_accum.py:167 reasons)."""
    params, state = _weights()
    half = _batch(b=2, seed=13)
    batch = {k: np.concatenate([v, v]) for k, v in half.items()}
    outs, models = [], []
    for accum in (1, 2):
        model = _port_model(params, state)
        optimizer = tstep.make_optimizer(model.parameters())
        gen = torch.Generator().manual_seed(0)
        if accum == 1:
            out = tstep.train_step(model, optimizer, _tensors(batch), gen, 1.0)
        else:
            out = tstep.train_step_accum(model, optimizer, _tensors(batch),
                                         gen, 1.0, accum_steps=2)
        outs.append(out)
        models.append(model)
    np.testing.assert_allclose(float(outs[1].loss), float(outs[0].loss),
                               rtol=1e-12)
    np.testing.assert_allclose(float(outs[1].grad_norm),
                               float(outs[0].grad_norm), rtol=1e-10)
    sd0, sd1 = models[0].state_dict(), models[1].state_dict()
    for k in sd0:
        if k.endswith("running_var"):
            continue  # unbiased by n / (n - 1): n differs by 2x
        torch.testing.assert_close(sd1[k], sd0[k], rtol=1e-9, atol=1e-10,
                                   msg=k)


# --- the audio frontend inside the step --------------------------------------

AUDIO_CFG = tst.ModelConfig(freq_bins=16, conv_feature_size=24,
                            hidden_size=16, max_bars=2, max_length=(8, 6),
                            note_emb_size=8, staff_emb_size=8)
VCFG = TVQTConfig(bins_per_octave=4, n_octaves=4)
T_ENC = 20
N_SAMPLES = (T_ENC - 1) * VCFG.hop_length


def _audio_batch(b=4, seed=1):
    rng = np.random.RandomState(seed)
    audio = (0.3 * rng.randn(b, N_SAMPLES)).astype(np.float32)
    audio[1, -700:] = 0.0     # trailing silence: ga_content below 1
    audio[2, 400:] = 0.0
    batch = {k: v for k, v in _batch(b=b, seed=seed).items()
             if k != "spectrogram"}
    for staff, cap in (("upper", 8), ("lower", 6)):
        batch[staff] = batch[staff][:, :, :cap]
        batch[staff][:, :, -1] = AUDIO_CFG.pad
        batch[f"{staff}_lengths"] = np.minimum(batch[f"{staff}_lengths"],
                                               cap - 2)
    return audio, batch


def test_audio_frontend_step_matches_spectrogram_step(x64):
    """A from-audio train step equals the spectrogram train step fed the
    same spectrogram; ga_content equals the JAX package's frontend's."""
    from piano_a2s_tpu.ops.vqt import VQTConfig as JVQTConfig
    audio, targets = _audio_batch()
    torch.manual_seed(0)
    init = tst.ScoreTranscription(AUDIO_CFG).state_dict()
    spec = t_get_vqt(torch.from_numpy(audio), cfg=VCFG)[:, None]
    results = []
    for from_audio in (False, True):
        model = tst.ScoreTranscription(AUDIO_CFG)
        model.load_state_dict(init)
        optimizer = tstep.make_optimizer(model.parameters())
        t_step, _ = tstep.make_train_steps(
            optimizer, from_audio=from_audio, vqt_cfg=VCFG,
            max_frame_num=T_ENC, device="cpu")
        batch = dict(targets, **({"audio": audio} if from_audio
                                 else {"spectrogram": spec}))
        out = t_step(model, batch, torch.Generator().manual_seed(1), 0.7)
        results.append((out, model.state_dict()))
    (out_s, sd_s), (out_a, sd_a) = results
    assert np.isfinite(float(out_a.loss))
    assert float(out_a.loss) == float(out_s.loss)
    for k in sd_s:
        torch.testing.assert_close(sd_a[k], sd_s[k], rtol=0, atol=0, msg=k)

    prep = tstep.make_audio_frontend(VCFG, T_ENC, device="cpu")
    got = prep({"audio": torch.from_numpy(audio)})
    jprep = jstep.make_audio_frontend(
        JVQTConfig(bins_per_octave=4, n_octaves=4), T_ENC)
    ref = jprep({"audio": jnp.asarray(audio)})
    np.testing.assert_array_equal(got["ga_content"].numpy(),
                                  np.asarray(ref["ga_content"]))
    assert got["ga_content"].dtype == torch.float32
    content = got["ga_content"].numpy()
    assert content[2] < content[1] < content[0] == content[3]
    np.testing.assert_allclose(got["spectrogram"].numpy(),
                               np.asarray(ref["spectrogram"]), atol=1e-5)


def test_audio_frontend_int16_matches_float():
    audio, _ = _audio_batch()
    pcm = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
    prep = tstep.make_audio_frontend(VCFG, T_ENC, device="cpu")
    a = prep({"audio": torch.from_numpy(pcm)})
    b = prep({"audio": torch.from_numpy(pcm.astype(np.float32) / 32768.0)})
    for k in ("spectrogram", "ga_content"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


# --- the pieces on their own -----------------------------------------------

def test_dropout_keep_rate_scale_and_seed():
    x = torch.ones(400_000, dtype=torch.float64)
    y = tL.dropout(x, 0.2, True, torch.Generator().manual_seed(4))
    kept = y != 0
    # Binomial: std sqrt(0.8 * 0.2 / 4e5) = 6.3e-4; 5 sigma.
    assert abs(kept.double().mean().item() - 0.8) < 3.2e-3
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.8))
    again = tL.dropout(x, 0.2, True, torch.Generator().manual_seed(4))
    other = tL.dropout(x, 0.2, True, torch.Generator().manual_seed(5))
    assert torch.equal(y, again) and not torch.equal(y, other)
    assert tL.dropout(x, 0.2, False) is x and tL.dropout(x, 0.0, True) is x


@pytest.mark.parametrize("weights", [None, [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]],
                         ids=["unweighted", "weighted", "all_zero"])
def test_batch_norm_train_matches_jax(x64, weights):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 4, 6) * 2 + 1
    bn = torch.nn.BatchNorm2d(5).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.randn(5)))
        bn.bias.copy_(torch.from_numpy(rng.randn(5)))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(5)))
        bn.running_var.copy_(torch.from_numpy(rng.rand(5) + 0.5))
    params = {"scale": bn.weight.detach().numpy().copy(),
              "bias": bn.bias.detach().numpy().copy()}
    state = {"mean": bn.running_mean.numpy().copy(),
             "var": bn.running_var.numpy().copy()}
    w = None if weights is None else np.asarray(weights)
    # JAX is NHWC: channels last; the port NCHW.
    y_j, s_j = jL.batch_norm(params, state,
                             jnp.asarray(x.transpose(0, 2, 3, 1)),
                             axes=(0, 1, 2), train=True,
                             weight=None if w is None else jnp.asarray(w))
    y_t = tL.batch_norm_train(torch.from_numpy(x), bn, axes=(0, 2, 3),
                              weight=None if w is None
                              else torch.from_numpy(w))
    np.testing.assert_allclose(y_t.detach().numpy(),
                               np.asarray(y_j).transpose(0, 3, 1, 2),
                               atol=1e-12)
    np.testing.assert_allclose(bn.running_mean.numpy(), s_j["mean"],
                               atol=1e-12)
    np.testing.assert_allclose(bn.running_var.numpy(), s_j["var"], atol=1e-12)


@pytest.mark.parametrize("mode", ["auto", "events", "tokens"])
def test_ga_within_bar_maps_match_jax(mode):
    batch = _batch(b=3, seed=17, events=True)
    gt = np.concatenate([batch["upper"][:, 0], batch["upper"][:, 1]])
    gt[0, :4] = [4, 60, CFG.newline, 6]    # a separator row
    gt[1, :4] = [4, 60, 145, 6]            # and one without
    gt[1][gt[1] == CFG.newline] = 8
    table = _duration_fraction_table(CFG.vocab_size)
    ref = jst.ga_within_bar_map(jnp.asarray(gt), table, CFG.pad,
                                CFG.newline, mode)
    got = tst.ga_within_bar_map(torch.from_numpy(gt),
                                torch.from_numpy(table), CFG.pad,
                                CFG.newline, mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    with pytest.raises(ValueError):
        tst.ga_within_bar_map(torch.from_numpy(gt), torch.from_numpy(table),
                              CFG.pad, CFG.newline, "bars")


def test_note_lengths_match_jax():
    rng = np.random.RandomState(2)
    for _ in range(20):
        sig = rng.rand(4, 9) < 0.15
        sig[rng.randint(4)] = False          # an item without EOS
        got = tst._note_lengths(torch.from_numpy(sig), 9)
        ref = jst._note_lengths(jnp.asarray(sig), 9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    sig = np.zeros((2, 5), bool)
    sig[0, 0] = True
    assert tst._note_lengths(torch.from_numpy(sig), 5).tolist() == [1, 5]


def test_losses_and_decomposition_match_jax(x64):
    rng = np.random.RandomState(4)
    b, bars, t, v = 4, 2, 6, 11
    outs_full = [np.log(rng.dirichlet(np.ones(n), size=shape))
                 for n, shape in ((7, (b, bars)), (14, (b, bars)),
                                  (v, (b, bars, t)), (v, (b, bars, t - 2)))]
    batch = {"time_sig": rng.randint(0, 7, (b, bars)),
             "key": rng.randint(0, 14, (b, bars)),
             "upper": rng.randint(0, v, (b, bars, t)),
             "lower": rng.randint(0, v, (b, bars, t - 2))}
    batch["upper"][:, :, -2:] = 3   # pad index 3 here
    ga_num = rng.rand(b, bars, 2)
    sw = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    picked = [outs_full[0], outs_full[1],
              np.take_along_axis(outs_full[2], batch["upper"][..., None],
                                 -1)[..., 0],
              np.take_along_axis(outs_full[3], batch["lower"][..., None],
                                 -1)[..., 0]]
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    tb = _tensors(batch)
    for weight in (None, sw):
        jw = None if weight is None else jnp.asarray(weight)
        tw = None if weight is None else torch.from_numpy(weight)
        pairs = [
            (jlosses.transcription_loss(
                [jnp.asarray(o) for o in outs_full], jb, 3, jw)[1],
             tlosses.transcription_loss(
                [torch.from_numpy(o) for o in outs_full], tb, 3, tw)[1]),
            (jlosses.transcription_loss_fused(
                [jnp.asarray(o) for o in picked] + [{"ga_num": ga_num}], jb,
                3, jw, ga_weight=0.5)[1],
             tlosses.transcription_loss_fused(
                [torch.from_numpy(o) for o in picked]
                + [{"ga_num": torch.from_numpy(ga_num)}], tb, 3, tw,
                ga_weight=0.5)[1]),
            (jlosses.fused_component_sums(
                [jnp.asarray(o) for o in picked] + [{"ga_num": ga_num}], jb,
                3, jw, ga_weight=0.5),
             tlosses.fused_component_sums(
                [torch.from_numpy(o) for o in picked]
                + [{"ga_num": torch.from_numpy(ga_num)}], tb, 3, tw,
                ga_weight=0.5)),
            (jlosses.component_totals(jb, 3, jw, ga=True),
             tlosses.component_totals(tb, 3, tw, ga=True))]
        for ref, got in pairs:
            _assert_comps(got, ref, atol=1e-6)


def test_duration_fraction_table_matches_jax():
    np.testing.assert_array_equal(tstep.duration_fraction_table(173),
                                  _duration_fraction_table(173))


def test_training_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = tst.ScoreTranscription(TCFG)
    optimizer = tstep.make_optimizer(model.parameters())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstep.make_train_steps(optimizer)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstep.make_audio_frontend()
    bad = _batch(b=1)
    bad["upper_lengths"][0, 0] = 0
    with pytest.raises(ValueError, match="at least 1"):
        model(torch.zeros(1, 1, 8, CFG.freq_bins), train=True,
              ground_truth=_gt(bad, torch.from_numpy))


def test_eval_step_runs_the_greedy_forward():
    params, state = _weights(nudge_state=0.05)
    model = _port_model(params, state)
    batch = _batch(b=2)
    _, e_step = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), device="cpu")
    out, preds = e_step(model, batch)
    assert np.isfinite(float(out.loss)) and not model.training
    greedy = model(torch.from_numpy(batch["spectrogram"]))
    torch.testing.assert_close(preds["upper_tokens"], greedy[4]["upper_tokens"])
    assert preds["time_sig"].shape == (2, CFG.max_bars)


def test_synthetic_audio_batch_is_well_formed_and_trains():
    """train/synthetic.py (chip_smoke.py phase g2's batches): EOS at each
    length inside the cap, <pad> after it, the same batch for the same
    seeds; one from-audio step on it gives a finite loss."""
    from piano_a2s_tpu_torch.train.synthetic import audio_batch
    batch = audio_batch(AUDIO_CFG, 3, N_SAMPLES, seed=4, targets_seed=5)
    again = audio_batch(AUDIO_CFG, 3, N_SAMPLES, seed=4, targets_seed=5)
    assert all(np.array_equal(batch[k], again[k]) for k in batch)
    assert batch["audio"].dtype == np.int16
    assert batch["audio"].shape == (3, N_SAMPLES)
    for staff, cap in (("upper", 8), ("lower", 6)):
        tok, lens = batch[staff], batch[f"{staff}_lengths"]
        assert tok.shape == (3, AUDIO_CFG.max_bars, cap)
        assert ((lens >= 1) & (lens <= cap - 2)).all()
        steps = np.arange(cap)
        eos = np.take_along_axis(tok, lens[..., None], -1)[..., 0]
        assert (eos == AUDIO_CFG.eos).all()
        after = steps > lens[..., None]
        assert (tok[after] == AUDIO_CFG.pad).all()
        before = tok[steps < lens[..., None]]
        assert not np.isin(before, [AUDIO_CFG.pad, AUDIO_CFG.eos]).any()
    model = tst.ScoreTranscription(AUDIO_CFG)
    t_step, _ = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), from_audio=True,
        vqt_cfg=VCFG, max_frame_num=T_ENC, device="cpu")
    out = t_step(model, batch, torch.Generator().manual_seed(0), 0.7)
    assert np.isfinite(float(out.loss))


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_marks_its_stages(accum_steps):
    """Every stage of the step the training entry point returns is a span
    (a record_function range under the profiler) that the benchmark's
    train.forward_ms and train.backward_ms and the breakdown read."""
    from torch.profiler import ProfilerActivity, profile
    model = _port_model(*_weights())
    t_step, _ = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), accum_steps=accum_steps,
        device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t_step(model, _batch(b=2), torch.Generator().manual_seed(0), 0.7)
    counts = {}
    for e in prof.events():
        counts[e.name] = counts.get(e.name, 0) + 1
    for stage in ("frontend", "forward", "loss", "backward"):
        assert counts.get(f"train_step/{stage}") == accum_steps, stage
    assert counts.get("train_step/update") == 1
    for stage in ("convstack", "encoder", "decoder"):
        assert counts.get(f"forward/{stage}") == accum_steps, stage
