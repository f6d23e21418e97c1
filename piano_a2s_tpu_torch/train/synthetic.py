"""Random training data made from a seed, for smoke runs and
measurements: int16 noise audio, random well-formed targets, and small
on-disk corpora in the datasets' layout."""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Tuple

import numpy as np

from ..data.datasets import load_time_signatures
from ..models.score_transcription import ModelConfig
from ..utils.audio import float32_to_int16


def pcm16_noise(shape: Tuple[int, ...], seed: int,
                amp: float = 0.1) -> np.ndarray:
    """Gaussian noise of standard deviation ``amp``, clipped to [-1, 1]
    and written as int16 PCM (x 32767)."""
    x = (amp * np.random.RandomState(seed).randn(*shape)).astype(np.float32)
    return float32_to_int16(np.clip(x, -1, 1))


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


def write_clips(folder: str, n_clips: int, seed: int,
                samples: Tuple[int, int], upper: Tuple[int, int],
                lower: Tuple[int, int], bars: int = 5) -> None:
    """Write ``n_clips`` clips in the datasets' layout under ``folder`` (a
    {split}/{version} or, for ASAP, a {split} folder): audio/clip<i>.npy,
    int16 noise of samples[0]..samples[1] samples; target/clip<i>.pkl,
    ``bars`` bars of [key, time signature, lower tokens, upper tokens]
    with upper[0]..upper[1] and lower[0]..lower[1] tokens a staff (random
    note tokens, some of them the event separator); and info/clip<i>.json.
    """
    rng = np.random.RandomState(seed)
    vocab = np.concatenate([np.arange(140), np.full(20, ModelConfig.newline)])
    time_sigs = load_time_signatures()
    for sub in ("audio", "target", "info"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)

    def staff(lo, hi):
        return [int(t) for t in rng.choice(vocab, rng.randint(lo, hi + 1))]

    for i in range(n_clips):
        name = f"clip{i}"
        n = rng.randint(samples[0], samples[1] + 1)
        np.save(os.path.join(folder, "audio", f"{name}.npy"),
                pcm16_noise((n,), seed * 1000 + i))
        target = [[int(rng.randint(-6, 8)),
                   time_sigs[rng.randint(len(time_sigs))],
                   staff(*lower), staff(*upper)] for _ in range(bars)]
        with open(os.path.join(folder, "target", f"{name}.pkl"), "wb") as f:
            pickle.dump(target, f)
        with open(os.path.join(folder, "info", f"{name}.json"), "w") as f:
            json.dump({"composer": "synthetic"}, f)
