"""Random training batches made from a seed, for smoke runs and
measurements: int16 noise audio and random well-formed targets."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def pcm16_noise(shape: Tuple[int, ...], seed: int,
                amp: float = 0.1) -> np.ndarray:
    """Gaussian noise of standard deviation ``amp``, clipped to [-1, 1]
    and written as int16 PCM (x 32767)."""
    x = (amp * np.random.RandomState(seed).randn(*shape)).astype(np.float32)
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def random_targets(cfg, batch: int, seed: int) -> Dict[str, np.ndarray]:
    """Targets for ``batch`` clips of model config ``cfg``: a time
    signature and a key per bar and, per staff and bar, n random tokens
    (some of them the event separator) with 1 <= n <= cap - 2, EOS at n
    and <pad> after it; "<staff>_lengths" holds n."""
    rng = np.random.RandomState(seed)
    vocab = np.concatenate([np.arange(140), np.full(20, cfg.newline)])
    out = {"time_sig": rng.randint(0, cfg.num_time_sig, (batch, cfg.max_bars)),
           "key": rng.randint(0, cfg.num_keys, (batch, cfg.max_bars))}
    for staff, cap in (("upper", cfg.max_length[0]),
                       ("lower", cfg.max_length[1])):
        tok = np.full((batch, cfg.max_bars, cap), cfg.pad, np.int64)
        lens = np.zeros((batch, cfg.max_bars), np.int64)
        for i in range(batch):
            for m in range(cfg.max_bars):
                n = rng.randint(1, cap - 1)
                tok[i, m, :n] = rng.choice(vocab, n)
                tok[i, m, n] = cfg.eos
                lens[i, m] = n
        out[staff], out[f"{staff}_lengths"] = tok, lens
    return out


def audio_batch(cfg, batch: int, samples: int, seed: int,
                targets_seed: int) -> Dict[str, np.ndarray]:
    """``random_targets(cfg, batch, targets_seed)`` with "audio", (batch,
    samples) int16 noise from ``seed``: a batch for training from audio."""
    return dict(random_targets(cfg, batch, targets_seed),
                audio=pcm16_noise((batch, samples), seed))
