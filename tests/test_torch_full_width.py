"""The port against the JAX package at the full production width
(``ModelConfig()``: 1201 x 480 spectrograms, ConvStack to 256, a 2-layer
BiGRU of 256, 5 bars, caps (398, 189), vocabulary 173), in float64.

The small widths of the other tests miss what only the real shapes
exercise: the staff padding to T = max(398, 189), the attention over 1201
frames and the real decode lengths. The weights come from JAX's
``init_params`` and cross with ``state_dict_from_jax``. With an EOS bias
on both staves' heads the greedy decode stops early, which keeps the
inference cases in Tier-1; the cap-bound decode and
the teacher-forced loss and gradients (the twins of
tests/test_full_size_parity.py) are marked ``slow``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import piano_a2s_tpu.ops.layers as jL
import piano_a2s_tpu_torch.ops.layers as tL
from piano_a2s_tpu.models import ModelConfig, forward, init_params, init_state
from piano_a2s_tpu.train import losses as jlosses
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import state_dict_from_jax
from piano_a2s_tpu_torch.train import losses as tlosses

torch.set_num_threads(4)

CFG = ModelConfig()
TCFG = tst.ModelConfig()
B, T_SPEC = 2, 1201
ATOL = 1e-8


@pytest.fixture(scope="module")
def x64():
    with jax.enable_x64(True):
        yield


def _weights(eos_bias):
    params = jax.tree.map(lambda x: np.array(x, np.float64),
                          init_params(jax.random.PRNGKey(3), CFG))
    state = jax.tree.map(lambda x: np.array(x, np.float64) + 0.05,
                         init_state(CFG))
    for staff in ("upper", "lower"):
        params["decoder"][staff]["out"]["b"][CFG.eos] += eos_bias
    return params, state


def _port_model(params, state):
    model = tst.ScoreTranscription(TCFG).double()
    model.load_state_dict(state_dict_from_jax(params, state, TCFG),
                          strict=True)
    return model


def _spec(seed=0):
    """A log-VQT-like input in [0, 1]."""
    return np.random.RandomState(seed).rand(B, 1, T_SPEC, CFG.freq_bins)


def _assert_inference_parity(eos_bias):
    params, state = _weights(eos_bias)
    spec = _spec()
    (ts, key, up, low, aux), _ = forward(
        params, state, jnp.asarray(spec), jax.random.PRNGKey(0), cfg=CFG,
        train=False)
    with torch.no_grad():
        t_ts, t_key, t_up, t_low, t_aux = _port_model(params, state).eval()(
            torch.from_numpy(spec))
    for got, ref in ((t_ts, ts), (t_key, key), (t_up, up), (t_low, low)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
    for k in ("upper_tokens", "lower_tokens", "upper_lengths",
              "lower_lengths"):
        np.testing.assert_array_equal(t_aux[k].numpy(), np.asarray(aux[k]),
                                      err_msg=k)
    return t_aux


@pytest.mark.parametrize("eos_bias", [3.0, 0.3],
                         ids=["eos_biased", "eos_biased_mixed"])
def test_full_width_eos_biased_inference_parity(x64, eos_bias):
    """At this width the heads' logits spread little: a bias of 3.0 stops
    every staff at its first step, 0.3 stops the upper staff within two
    steps a bar and runs the lower one to its cap of 189 in some bars (one
    staff stopped while the other runs on, in the padded T = 398)."""
    aux = _assert_inference_parity(eos_bias)
    up_len, low_len = aux["upper_lengths"], aux["lower_lengths"]
    assert (up_len < CFG.max_length[0]).all()
    if eos_bias == 3.0:
        assert (low_len < CFG.max_length[1]).all()
    else:
        assert (low_len == CFG.max_length[1]).any()
        assert (low_len < CFG.max_length[1]).any()


@pytest.mark.slow
def test_full_width_cap_bound_inference_parity(x64):
    aux = _assert_inference_parity(0.0)
    assert (aux["upper_lengths"] == CFG.max_length[0]).any()


def _ground_truth(seed=1, fill=0.6):
    """Targets at production lengths: tokens, EOS, <pad> (as
    tests/test_full_size_parity.py's)."""
    rng = np.random.RandomState(seed)
    out = {"time_sig": rng.randint(0, CFG.num_time_sig, (B, CFG.max_bars)),
           "key": rng.randint(0, CFG.num_keys, (B, CFG.max_bars))}
    for staff, cap in (("upper", CFG.max_length[0]),
                       ("lower", CFG.max_length[1])):
        tok = np.full((B, CFG.max_bars, cap), CFG.pad, np.int64)
        lens = np.zeros((B, CFG.max_bars), np.int64)
        for b in range(B):
            for m in range(CFG.max_bars):
                n = rng.randint(1, int(cap * fill))
                tok[b, m, :n] = rng.randint(0, 140, n)
                tok[b, m, n] = CFG.eos
                lens[b, m] = n
        out[staff], out[f"{staff}_lengths"] = tok, lens
    return out


_GT_KEYS = ("time_sig", "key", "upper", "upper_lengths", "lower",
            "lower_lengths")


@pytest.mark.slow
def test_full_width_teacher_forced_loss_and_grads(x64, monkeypatch):
    """Train-mode forward (dropout patched out in both packages), tf 1.0,
    the fused loss and every parameter's gradient."""
    monkeypatch.setattr(jL, "dropout", lambda key, x, rate, train: x)
    monkeypatch.setattr(tL, "dropout",
                        lambda x, rate, train, generator=None, rows=None: x)
    params, state = _weights(0.0)
    spec, gt = _spec(2), _ground_truth()
    jbatch = {k: jnp.asarray(v) for k, v in gt.items()}

    def loss_fn(p):
        outs, _ = forward(p, state, jnp.asarray(spec), jax.random.PRNGKey(0),
                          cfg=CFG, train=True,
                          ground_truth=tuple(jbatch[k] for k in _GT_KEYS),
                          tf_ratio=1.0, emit_full=False)
        return jlosses.transcription_loss_fused(outs, jbatch, CFG.pad)

    (loss_j, comps_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        params)

    model = _port_model(params, state)
    tb = {k: torch.from_numpy(v) for k, v in gt.items()}
    outs = model(torch.from_numpy(spec), train=True,
                 ground_truth=tuple(tb[k] for k in _GT_KEYS), tf_ratio=1.0,
                 emit_full=False, generator=torch.Generator().manual_seed(0))
    loss_t, comps_t = tlosses.transcription_loss_fused(outs, tb, CFG.pad)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               atol=ATOL, rtol=0)
    for k in comps_j:
        np.testing.assert_allclose(float(comps_t[k]), float(comps_j[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    zero = jax.tree.map(np.zeros_like, init_state(CFG))
    ref = state_dict_from_jax(jax.tree.map(np.asarray, grads_j), zero, TCFG)
    n = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=ATOL, rtol=0, err_msg=name)
        n += 1
    assert n > 50
