"""Module self-test, the twin of ``python -m piano_a2s_tpu.models``
(reference: models.py:588-602 — random-input forward + parameter count).

    python -m piano_a2s_tpu_torch.models [--full] [--device cuda|cpu]

Default runs a reduced-size forward in seconds (the JAX self-test's reduced
configuration); --full uses the production configuration (1201x480 input,
5 bars x (398,189)). It runs on the card unless ``--device cpu`` is given.
"""

import argparse
import sys

import numpy as np
import torch

from ..utils.device import resolve_device
from . import ModelConfig, ScoreTranscription, init_state_dict


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="random-input forward and parameter count")
    parser.add_argument("--full", action="store_true",
                        help="the production configuration")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, cuda:N or cpu)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.full:
        cfg = ModelConfig()
        frames = 1201
    else:
        cfg = ModelConfig(freq_bins=24, conv_feature_size=24,
                          hidden_size=24, max_bars=2, max_length=(10, 8),
                          note_emb_size=8, staff_emb_size=8)
        frames = 40

    model = ScoreTranscription(cfg)
    model.load_state_dict(init_state_dict(cfg, seed=0), strict=True)
    model.to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"config: {cfg}")
    print(f"parameters: {n_params:,}")

    spec = torch.from_numpy(np.random.RandomState(0).randn(
        1, 1, frames, cfg.freq_bins).astype(np.float32)).to(device)
    ts, key, up, low, aux = model(spec)
    print(f"time_sig: {tuple(ts.shape)}  key: {tuple(key.shape)}")
    print(f"upper log-probs: {tuple(up.shape)}  "
          f"lower log-probs: {tuple(low.shape)}")
    print(f"upper tokens: {tuple(aux['upper_tokens'].shape)}  "
          f"lengths: {aux['upper_lengths'][0].cpu().numpy()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
