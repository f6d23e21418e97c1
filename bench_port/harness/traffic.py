"""The one traffic generator: what a mix file's parameters describe, drawn
from the run's seed.

A mix (``traffic/<name>.json``) may set:

- ``batch``: clips per call (a closed-loop caller) or per training step;
- ``clip_seconds`` [lo, hi]: each clip's length, uniform (equal ends for a
  fixed length);
- ``audio``: {"dtype": "float32" | "int16", "amplitude": the noise's
  standard deviation in full-scale units};
- ``pool``: how many distinct batches (or requests) are made at set-up
  and offered in turn;
- ``targets``: {"bar_lengths": a file of ``data/``, "bucket": the width
  multiple a batch's targets are cut to}, for training.

Every draw is a function of (seed, stream, index), so two runs of one seed
offer the same work in the same order, and any seed offers the same sizes.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from .spec import data_path

STREAM_AUDIO, STREAM_TARGETS, STREAM_SAMPLE = 1, 2, 4


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream, index])


def clip(traffic: dict, seed: int, index: int, sample_rate: int) -> np.ndarray:
    """Clip ``index``: noise of the mix's amplitude and a length drawn from
    ``clip_seconds``, in the mix's dtype (int16 PCM at x 32768, clipped)."""
    g = rng(seed, STREAM_AUDIO, index)
    lo, hi = traffic["clip_seconds"]
    n = int(round(g.uniform(lo, hi) * sample_rate)) if hi > lo \
        else int(lo * sample_rate)
    audio = traffic["audio"]
    x = g.standard_normal(n, dtype=np.float32) * np.float32(audio["amplitude"])
    if audio["dtype"] == "int16":
        return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return np.clip(x, -1.0, 1.0)


def clips(traffic: dict, seed: int, start: int, n: int,
          sample_rate: int) -> List[np.ndarray]:
    return [clip(traffic, seed, start + i, sample_rate) for i in range(n)]


def bar_lengths(traffic: dict) -> Dict[str, List[int]]:
    with open(data_path(traffic["targets"]["bar_lengths"])) as f:
        return json.load(f)["lengths"]


def targets(traffic: dict, model: dict, seed: int, index: int,
            lengths: Dict[str, List[int]]) -> Dict[str, np.ndarray]:
    """Targets of training batch ``index``: per clip and bar a time
    signature and a key, uniform over their classes, and per staff a bar
    of tokens uniform over the non-special vocabulary, its length drawn
    from the real bars in ``lengths``, then one <eos> and <pad> to the
    width. The width is the batch's longest bar plus the <eos>, rounded up
    to ``bucket`` and at most the staff's cap (the trainer's rule)."""
    g = rng(seed, STREAM_TARGETS, index)
    b, bars = traffic["batch"], model["max_bars"]
    special = {model["sos"], model["eos"], model["pad"]}
    vocab = np.array([t for t in range(model["vocab_size"])
                      if t not in special])
    out = {"time_sig": g.integers(0, model["num_time_sig"], (b, bars)),
           "key": g.integers(0, model["num_keys"], (b, bars))}
    q = traffic["targets"]["bucket"]
    for staff, cap in zip(("upper", "lower"), model["max_length"]):
        pool = np.asarray(lengths[staff])
        n = np.minimum(g.choice(pool, (b, bars)), cap - 1)
        width = min(-(-(int(n.max()) + 1) // q) * q, cap)
        toks = np.full((b, bars, width), model["pad"], np.int64)
        ids = g.choice(vocab, (b, bars, width))
        steps = np.arange(width)
        toks = np.where(steps < n[..., None], ids, toks)
        toks = np.where(steps == n[..., None], model["eos"], toks)
        out[staff] = toks
        out[f"{staff}_lengths"] = n
    return {k: v.astype(np.int64) for k, v in out.items()}

