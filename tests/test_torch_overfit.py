"""Learning check of the port, the twin of tests/test_overfit.py: at that
test's configuration and batch, the port's train_step memorizes the batch
(the loss falls below a quarter of the first) and its free-running greedy
decode reproduces the memorized tokens, with the ConvStack in float32 and
in bfloat16."""

import jax
import numpy as np
import pytest
import torch

from piano_a2s_tpu.models import init_params, init_state
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import state_dict_from_jax
from piano_a2s_tpu_torch.train import step as tstep
from test_overfit import CFG, _fixed_batch

torch.set_num_threads(2)

TCFG = tst.ModelConfig(**{f: getattr(CFG, f) for f in
                          CFG.__dataclass_fields__})


@pytest.mark.parametrize("conv_dtype", [None, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_overfit_tiny_batch(conv_dtype):
    model = tst.ScoreTranscription(TCFG)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), CFG)),
        jax.tree.map(np.asarray, init_state(CFG)), TCFG), strict=True)
    t_step, e_step = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters(), lr=1.0),
        conv_dtype=conv_dtype, device="cpu")
    batch = _fixed_batch()
    gen = torch.Generator().manual_seed(0)
    losses = [float(t_step(model, batch, gen, 1.0).loss) for _ in range(150)]
    assert losses[-1] < losses[0] * 0.25, (losses[0], losses[-1])

    # The free-running decode (eval-mode BatchNorm) reproduces the
    # memorized sequences: tokens plus EOS, tests/test_overfit.py's measure.
    _, preds = e_step(model, batch)
    up_tok = preds["upper_tokens"].numpy()
    matches = total = 0
    for i in range(batch["upper"].shape[0]):
        for m in range(CFG.max_bars):
            n = batch["upper_lengths"][i, m] + 1
            total += n
            matches += (up_tok[i, m, :n] == batch["upper"][i, m, :n]).sum()
    assert matches / total > 0.8, f"decode memorization {matches}/{total}"
