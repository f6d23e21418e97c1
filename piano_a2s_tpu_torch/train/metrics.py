"""Sequence helpers of piano_a2s_tpu/train/metrics.py that the port uses."""

from __future__ import annotations

import numpy as np

from ..symbolic.vocab import LabelsMultiple

EOS = LabelsMultiple(extended=True).labels_map["<eos>"]


def unpad(full_seq: np.ndarray) -> np.ndarray:
    """Truncate a sequence at its first EOS (reference: pretrain.py:245-249)."""
    full_seq = np.asarray(full_seq)
    where = np.nonzero(full_seq == EOS)[0]
    length = int(where[0]) if where.size else full_seq.shape[0]
    return full_seq[:length]
