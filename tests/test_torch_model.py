"""The port's full inference forward against the JAX package in float64,
and the weight converters.

Two decode regimes: free-running (an untrained model rarely emits EOS, so
every staff runs to its cap) and EOS-biased (staves stop early, batch items
at different steps, so the batch-coupled stop, the last-EOS lengths and the
zeroed buffers after a stop are all exercised)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from piano_a2s_tpu.models import ModelConfig, forward, init_params, init_state
from piano_a2s_tpu.models.convert import to_torch_state_dict
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import (init_state_dict,
                                                load_torch_checkpoint,
                                                state_dict_from_jax)

torch.set_num_threads(2)

# tests/test_export_torch.py's small configuration.
CFG = ModelConfig(freq_bins=32, conv_feature_size=64, hidden_size=48,
                  max_bars=2, max_length=(12, 9), note_emb_size=8,
                  staff_emb_size=8, time_sig_emb_size=5, key_emb_size=8)
TCFG = tst.ModelConfig(**{f: getattr(CFG, f) for f in
                          CFG.__dataclass_fields__})
B, T_SPEC = 3, 40
ATOL = 1e-8


@pytest.fixture(scope="module")
def x64():
    with jax.enable_x64(True):
        yield


def _jax_weights(eos_bias: float):
    params = init_params(jax.random.PRNGKey(11), CFG)
    state = jax.tree.map(lambda x: x + 0.05, init_state(CFG))
    params = jax.tree.map(lambda x: np.array(x, np.float64), params)
    state = jax.tree.map(lambda x: np.array(x, np.float64), state)
    for d in ("upper", "lower"):
        params["decoder"][d]["out"]["b"][CFG.eos] += eos_bias
    return params, state


@pytest.mark.parametrize("eos_bias", [0.0, 3.0],
                         ids=["free_running", "eos_biased"])
def test_forward_parity(x64, eos_bias):
    params, state = _jax_weights(eos_bias)
    # Scaled so the conv features are not all zeroed by the last ReLU.
    spec = 10.0 * np.random.RandomState(5).randn(B, 1, T_SPEC,
                                                 CFG.freq_bins)
    (ts, key, up, low, aux), _ = forward(
        params, state, jnp.asarray(spec), jax.random.PRNGKey(0), cfg=CFG,
        train=False)

    model = tst.ScoreTranscription(TCFG).double().eval()
    model.load_state_dict(state_dict_from_jax(params, state, TCFG),
                          strict=True)
    t_ts, t_key, t_up, t_low, t_aux = model(torch.from_numpy(spec))

    for got, ref in ((t_ts, ts), (t_key, key), (t_up, up), (t_low, low)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    for k in ("upper_tokens", "lower_tokens", "upper_lengths",
              "lower_lengths"):
        np.testing.assert_array_equal(t_aux[k].numpy(), np.asarray(aux[k]),
                                      err_msg=k)

    up_len = t_aux["upper_lengths"].numpy()
    if eos_bias:
        # Some staff stopped before its cap; its buffer tail stays zero.
        assert (up_len < CFG.max_length[0]).any()
        stop = up_len.max(axis=0)  # per bar: the batch-coupled stop step
        for bar, t_stop in enumerate(stop):
            assert not t_up[:, bar, t_stop:].any()
    else:
        assert (up_len == CFG.max_length[0]).all()


def test_state_dict_from_jax_matches_exporter(x64):
    params, state = _jax_weights(0.0)
    ref = to_torch_state_dict(params, state, CFG)
    got = state_dict_from_jax(params, state, TCFG)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k
    tst.ScoreTranscription(TCFG).double().load_state_dict(got, strict=True)


def test_init_state_dict_strict_loads_and_is_seeded():
    ref = to_torch_state_dict(
        *jax.tree.map(np.asarray, (init_params(jax.random.PRNGKey(0), CFG),
                                   init_state(CFG))), CFG)
    sd = init_state_dict(TCFG, seed=3)
    assert list(sd) == list(ref)
    for k in ref:
        assert sd[k].shape == ref[k].shape, k
    tst.ScoreTranscription(TCFG).load_state_dict(sd, strict=True)
    again = init_state_dict(TCFG, seed=3)
    other = init_state_dict(TCFG, seed=4)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["encoder.fc.weight"],
                           other["encoder.fc.weight"])
    # The candidate-gate block of the reference's GRU init is orthogonal.
    w_n = sd["encoder.gru.weight_hh_l0"][2 * CFG.hidden_size:].double()
    np.testing.assert_allclose((w_n @ w_n.T).numpy(),
                               np.eye(CFG.hidden_size), atol=1e-6)


def test_load_torch_checkpoint_strips_module_list_prefix(tmp_path):
    sd = init_state_dict(TCFG, seed=1)
    path = str(tmp_path / "model.ckpt")
    torch.save({f"0.{k}": v for k, v in sd.items()}, path)
    loaded = load_torch_checkpoint(path)
    assert list(loaded) == list(sd)
    tst.ScoreTranscription(TCFG).load_state_dict(loaded, strict=True)
    torch.save({"state_dict": sd}, path)
    assert list(load_torch_checkpoint(path)) == list(sd)


def test_training_forward_needs_ground_truth():
    """A training forward without ground truth, a greedy decode in
    training mode, is not a thing the port has: the training forward is
    the teacher-forced one (tests/test_torch_train.py), and train=True
    without ground truth raises."""
    model = tst.ScoreTranscription(TCFG)
    with pytest.raises(ValueError, match="ground_truth"):
        model(torch.zeros(1, 1, 8, CFG.freq_bins), train=True)
