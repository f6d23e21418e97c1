"""Plain-text epoch logger, a copy of piano_a2s_tpu/train/logger.py, in
the spirit of SpeechBrain's FileTrainLogger (one line per epoch: stage
meta + per-stage stats; reference: hparams/pretrain.yaml:118-119,
pretrain.py:180-184). The exact separators/float formats are OURS, not
byte-compatible with SpeechBrain's — don't diff train_log.txt against a
reference run's."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


def _fmt(value: Any) -> str:
    if isinstance(value, float):
        return f"{value:.2e}" if (abs(value) < 1e-2 and value != 0) \
            else f"{value:.4f}"
    return str(value)


class FileTrainLogger:
    def __init__(self, save_file: str):
        self.save_file = save_file
        os.makedirs(os.path.dirname(os.path.abspath(save_file)),
                    exist_ok=True)

    def log_stats(self, stats_meta: Dict[str, Any],
                  train_stats: Optional[Dict[str, Any]] = None,
                  valid_stats: Optional[Dict[str, Any]] = None,
                  test_stats: Optional[Dict[str, Any]] = None) -> str:
        parts = [f"{k}: {_fmt(v)}" for k, v in stats_meta.items()]
        for name, stats in (("train", train_stats), ("valid", valid_stats),
                            ("test", test_stats)):
            if stats:
                parts.extend(f"{name} {k}: {_fmt(v)}"
                             for k, v in stats.items())
        line = ", ".join(parts)
        with open(self.save_file, "a") as f:
            f.write(line + "\n")
        return line
