"""Port layers against the JAX package in float64: the eval conv stack (BN
folded, torch flatten order), the encoder's two outputs (nn.GRU's, and K4's
plain twin's at the paper's widths), one attention step, and the packed
staff-summariser GRU on ragged lengths."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from piano_a2s_tpu.models import ModelConfig, init_params, init_state
from piano_a2s_tpu.models import score_transcription as jst
from piano_a2s_tpu.ops import attention as jatt
from piano_a2s_tpu.ops import gru as jgru
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import state_dict_from_jax
from piano_a2s_tpu_torch.ops import attention as tatt
from piano_a2s_tpu_torch.ops import gru as tgru

torch.set_num_threads(2)

# tests/test_export_torch.py's small configuration.
CFG = ModelConfig(freq_bins=32, conv_feature_size=64, hidden_size=48,
                  max_bars=2, max_length=(12, 9), note_emb_size=8,
                  staff_emb_size=8, time_sig_emb_size=5, key_emb_size=8)
TCFG = tst.ModelConfig(**{f: getattr(CFG, f) for f in
                          CFG.__dataclass_fields__})
B, T_SPEC = 2, 40
ATOL = 1e-10


@pytest.fixture(scope="module")
def x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(scope="module")
def weights(x64):
    """JAX float64 params/state (BN stats nudged off 0/1) and the port model
    holding the same weights."""
    params = init_params(jax.random.PRNGKey(11), CFG)
    state = jax.tree.map(lambda x: x + 0.05, init_state(CFG))
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
    state = jax.tree.map(lambda x: np.asarray(x, np.float64), state)
    model = tst.ScoreTranscription(TCFG).double().eval()
    model.load_state_dict(state_dict_from_jax(params, state, TCFG),
                          strict=True)
    return params, state, model


def _spec(seed=5):
    # Scaled by 10: at unit scale every feature of this randomly initialised
    # conv stack falls below the nudged BN mean and the last ReLU zeroes it.
    return 10.0 * np.random.RandomState(seed).randn(B, 1, T_SPEC,
                                                    CFG.freq_bins)


def test_conv_stack_eval(weights):
    params, state, model = weights
    x = _spec()
    ref, _ = jst.conv_stack_apply(params["convstack"], state["convstack"],
                                  jnp.asarray(x), False, None)
    with torch.no_grad():
        got = model.convstack(torch.from_numpy(x))
    assert got.shape == (B, T_SPEC, CFG.conv_feature_size)
    assert (got > 0).double().mean() > 0.3
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_conv_stack_flatten_order_matters(weights):
    """The flatten-linear weight is laid out c*F + f; reading it as the JAX
    package's f*C + c order gives different features."""
    params, state, model = weights
    x = torch.from_numpy(_spec())
    with torch.no_grad():
        good = model.convstack(x)
        w = model.convstack.out.weight.clone()
        n_out = w.shape[0]
        model.convstack.out.weight.copy_(
            w.reshape(n_out, 40, CFG.freq_bins).transpose(1, 2)
            .reshape(n_out, -1))
        try:
            wrong = model.convstack(x)
        finally:
            model.convstack.out.weight.copy_(w)
    assert (good - wrong).abs().max() > 1e-3


def test_encoder_outputs(weights):
    params, _, model = weights
    feats = np.random.RandomState(6).randn(B, T_SPEC, CFG.conv_feature_size)
    enc_ref, hid_ref = jst.encoder_apply(params["encoder"],
                                         jnp.asarray(feats))
    with torch.no_grad():
        enc, hid = model.encoder(torch.from_numpy(feats))
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_ref), atol=ATOL)
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_ref), atol=ATOL)


def test_encoder_counts_its_rows_on_nn_gru(weights):
    """On the CPU the encoder's GRU is nn.GRU (K4 runs on a card only): the
    forward/encoder span counts the batch's rows, none of them K4's."""
    from torch.profiler import ProfilerActivity, profile

    from piano_a2s_tpu_torch.utils import profiling as P

    _, _, model = weights
    feats = torch.from_numpy(np.random.RandomState(6).randn(
        B, T_SPEC, CFG.conv_feature_size))
    P.RECORDER.clear()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        with P.span("forward/encoder", ranged=False):
            model.encoder(feats)
    span, = [r for r in P.records(0, 2 ** 63) if r.name == "forward/encoder"]
    P.RECORDER.clear()
    assert not tst.uses_k4(feats, model.encoder.gru)
    assert span.counts == {"encoder_rows": B, "encoder_kernel_rows": 0}


@pytest.mark.parametrize("rows", [8, 16, 24])
def test_encoder_gru_twin_matches_the_jax_package(x64, monkeypatch, rows):
    """K4's plain twin (tests/test_torch_encoder_gru_cuda.py) at its own
    widths (input and hidden 256), run through Encoder.forward's K4 branch,
    against the JAX package's encoder_apply on the same weights: enc and
    the bridge from h_n, on one chunk of rows and several, rows padded past
    B."""
    from test_torch_encoder_gru_cuda import encoder_gru_plain

    from piano_a2s_tpu_torch.ops import encoder_gru_cuda as K4

    torch.manual_seed(3)
    encoder = tst.Encoder(tst.ModelConfig()).double().eval()
    gru = encoder.gru

    def direction(layer, suffix):
        return {k: getattr(gru, f"{kind}_{k[2:]}_l{layer}{suffix}")
                .detach().numpy().T for k, kind in (
                    ("w_ih", "weight"), ("w_hh", "weight"),
                    ("b_ih", "bias"), ("b_hh", "bias"))}

    params = {f"l{layer}_{d}": direction(layer, suffix)
              for layer in (0, 1) for d, suffix in (("fwd", ""),
                                                    ("bwd", "_reverse"))}
    params["fc"] = {"w": encoder.fc.weight.detach().numpy().T,
                    "b": encoder.fc.bias.detach().numpy()}
    x = np.random.RandomState(rows).randn(10, 5, K4.INPUT)
    enc_ref, hid_ref = jst.encoder_apply(params, jnp.asarray(x))
    monkeypatch.setattr(tst, "uses_k4", lambda *a: True)
    monkeypatch.setattr(K4, "encoder_gru_cuda",
                        lambda g, inp: encoder_gru_plain(g, inp, rows))
    with torch.no_grad():
        enc, hid = encoder(torch.from_numpy(x))
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_ref), atol=ATOL)
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_ref), atol=ATOL)


def test_attention_step(weights):
    params, _, model = weights
    rng = np.random.RandomState(7)
    h = CFG.hidden_size
    enc = rng.randn(B, T_SPEC, 2 * h)
    query = rng.randn(B, 2 * h)
    p = params["decoder"]["attn"]
    ctx_ref, w_ref = jatt.attention_step(
        p, jatt.precompute_enc_proj(p, jnp.asarray(enc)), jnp.asarray(enc),
        jnp.asarray(query))
    attn = model.decoder.attn
    with torch.no_grad():
        enc_t = torch.from_numpy(enc)
        ctx, w = tatt.attention_step(attn,
                                     tatt.precompute_enc_proj(attn, enc_t),
                                     enc_t, torch.from_numpy(query))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_ref), atol=ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=ATOL)


def test_bidir_final_fused_ragged(weights):
    """Packed final hidden: the backward direction starts at length-1, so
    the padding after it never reaches the summary."""
    params, _, model = weights
    rng = np.random.RandomState(8)
    S, T = 2, 7
    xs = rng.randn(S, B, T, CFG.note_emb_size)
    lengths = np.array([[1, 7], [4, 2]])
    dec = params["decoder"]
    ref = jgru.bidir_final_fused(dec["staff_fwd"], dec["staff_bwd"],
                                 jnp.asarray(xs), jnp.asarray(lengths))
    with torch.no_grad():
        got = tgru.bidir_final_fused(model.decoder.staff_emb,
                                     torch.from_numpy(xs),
                                     torch.from_numpy(lengths))
        # Garbage after each sequence's end changes nothing.
        noisy = xs.copy()
        for s in range(S):
            for b in range(B):
                noisy[s, b, lengths[s, b]:] = 1e3
        got_noisy = tgru.bidir_final_fused(model.decoder.staff_emb,
                                           torch.from_numpy(noisy),
                                           torch.from_numpy(lengths))
    assert got.shape == (S, B, 2 * CFG.staff_emb_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(got_noisy.numpy(), got.numpy())


def test_staff_summary_twin_matches_the_jax_package(weights):
    """K3's plain twin (tests/test_torch_staff_summary_cuda.py) against the
    JAX package's bidir_final_fused on ragged lengths, 1 and T among
    them."""
    from test_torch_staff_summary_cuda import staff_summary_plain

    params, _, model = weights
    rng = np.random.RandomState(9)
    S, T = 3, 7
    tokens = rng.randint(0, CFG.vocab_size, (S, B, T))
    lengths = np.array([[1, 7], [4, 2], [7, 1]])
    dec = params["decoder"]
    xs = np.asarray(dec["note_emb"]["emb"])[tokens]
    ref = jgru.bidir_final_fused(dec["staff_fwd"], dec["staff_bwd"],
                                 jnp.asarray(xs), jnp.asarray(lengths))
    with torch.no_grad():
        got = staff_summary_plain(model.decoder.staff_emb,
                                  model.decoder.note_emb.weight,
                                  torch.from_numpy(tokens),
                                  torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_gru_step(weights):
    params, _, model = weights
    rng = np.random.RandomState(9)
    x = rng.randn(B, CFG.bar_gru_in)
    h = rng.randn(B, 2 * CFG.hidden_size)
    ref = jgru.gru_step(params["decoder"]["gru"], jnp.asarray(x),
                        jnp.asarray(h))
    with torch.no_grad():
        got = tgru.gru_step(model.decoder.gru, torch.from_numpy(x),
                            torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
