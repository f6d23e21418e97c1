"""The port's entry (piano_a2s_tpu_torch/entry.py), the twin of
__graft_entry__.py, on the CPU: ``entry()``'s greedy forward against the
JAX package's forward on the same weights, its full-width default, and
``dryrun_multichip(2)`` over two gloo ranks."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import REPO_ROOT
from piano_a2s_tpu.models import ModelConfig as JaxModelConfig
from piano_a2s_tpu.models import forward
from piano_a2s_tpu.models.convert import from_torch_state_dict
from piano_a2s_tpu_torch import entry as tentry
from piano_a2s_tpu_torch.models import ModelConfig

torch.set_num_threads(2)

# tests/test_torch_infer.py's width.
CFG = ModelConfig(freq_bins=12, conv_feature_size=16, hidden_size=16,
                  max_bars=2, max_length=(8, 6), note_emb_size=8,
                  staff_emb_size=8)
DRYRUN_TIMEOUT_S = 240


def test_entry_tokens_equal_jax_forward():
    """entry(device="cpu", cfg=CFG): its (1, 1, 1201, 12) spectrogram and
    seed-0 weights through the JAX package's forward give the same time
    and key signatures and tokens."""
    fn, (model, spec) = tentry.entry(device="cpu", cfg=CFG)
    assert tuple(spec.shape) == (1, 1, tentry.FRAMES, CFG.freq_bins)
    with torch.no_grad():
        ts, key, up, low = fn(model, spec)
    jcfg = JaxModelConfig(**{f: getattr(CFG, f)
                             for f in CFG.__dataclass_fields__})
    params, state = from_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    (j_ts, j_key, _, _, aux), _ = forward(
        params, state, jnp.asarray(spec.numpy()), jax.random.PRNGKey(0),
        cfg=jcfg, train=False)
    np.testing.assert_array_equal(ts.argmax(-1).numpy(),
                                  np.asarray(j_ts).argmax(-1))
    np.testing.assert_array_equal(key.argmax(-1).numpy(),
                                  np.asarray(j_key).argmax(-1))
    np.testing.assert_array_equal(up.numpy(), np.asarray(aux["upper_tokens"]))
    np.testing.assert_array_equal(low.numpy(),
                                  np.asarray(aux["lower_tokens"]))
    assert up.shape == (1, CFG.max_bars, CFG.max_length[0])


def test_entry_defaults_to_full_width():
    _, (model, spec) = tentry.entry(device="cpu")
    assert model.cfg == ModelConfig()
    assert tuple(spec.shape) == (1, 1, 1201, 480)


def test_dryrun_multichip_two_ranks():
    """python -m piano_a2s_tpu_torch.entry multichip 2 --device cpu: every
    rank's losses finite (the ranks raise otherwise), within its time
    limit."""
    r = subprocess.run(
        [sys.executable, "-m", "piano_a2s_tpu_torch.entry", "multichip",
         "2", "--device", "cpu"], capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT_S, cwd=REPO_ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "dryrun_multichip(2) on cpu OK" in r.stdout
