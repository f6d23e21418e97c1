"""Evaluation metrics, a copy of piano_a2s_tpu/train/metrics.py: word
error rate (jiwer-compatible) and macro-F1 (sklearn-compatible), plus the
reference's sequence helpers.

All host-side numpy/python — these run on decoded token strings between
epochs (reference: pretrain.py:216-249).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..symbolic.vocab import LabelsMultiple

_labels = LabelsMultiple(extended=True)
EOS = _labels.labels_map["<eos>"]


def _words(s: str) -> List[str]:
    return [w for w in s.split(" ") if w]


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance, numpy-vectorized rows (the eval loop computes
    this on ~2000-word sequences per clip; pure-Python DP dominates eval
    wall-clock)."""
    if len(ref) == 0:
        return len(hyp)
    if len(hyp) == 0:
        return len(ref)
    # Map tokens to ints for fast vector comparison.
    vocab = {}
    ref_ids = np.fromiter((vocab.setdefault(t, len(vocab)) for t in ref),
                          np.int32, len(ref))
    hyp_ids = np.fromiter((vocab.setdefault(t, len(vocab)) for t in hyp),
                          np.int32, len(hyp))
    prev = np.arange(len(hyp) + 1, dtype=np.int64)
    ar = np.arange(len(prev))  # loop-invariant index ramp
    for i, r in enumerate(ref_ids, 1):
        sub = prev[:-1] + (hyp_ids != r)
        dele = prev[1:] + 1
        cur = np.empty_like(prev)
        cur[0] = i
        np.minimum(sub, dele, out=cur[1:])
        # Insertions propagate left-to-right: cur[j] = min(cur[j], cur[j-1]+1)
        # == prefix-min of (cur[j] - j), shifted back.
        tmp = cur - ar
        np.minimum.accumulate(tmp, out=tmp)
        prev = tmp + ar
    return int(prev[-1])


def word_error_rate(truth: str, hypothesis: str) -> float:
    """jiwer.wer-compatible: (S+D+I) / reference length.

    Matches jiwer's default transformation chain exactly on its defined
    domain: RemoveMultipleSpaces + Strip + split on single spaces (_words
    drops empty fields, which is the same thing); non-space whitespace
    like the bar-join's "\\n" stays a word of its own; WER may exceed 1.0
    (insertions). One documented DIVERGENCE: jiwer raises ValueError when
    the reference reduces to zero words — we return the insertion count
    (len(hyp)) instead of crashing mid-epoch. calculate_wer's references
    are non-empty whenever a clip has >=2 bars (the " \\n = \\n " join
    contributes "=" words), so the reference's jiwer call never hits this
    in practice (reference: pretrain.py:216-227); pinned in
    tests/test_train_components.py::test_wer_jiwer_edge_semantics."""
    ref, hyp = _words(truth), _words(hypothesis)
    if not ref:
        return 0.0 if not hyp else float(len(hyp))
    return edit_distance(ref, hyp) / len(ref)


def idx2string(idx_seq: Sequence[int]) -> str:
    """Token ids -> space-joined label strings (reference:
    pretrain.py:229-234)."""
    return " ".join(_labels.labels_map_inv[int(i)] for i in idx_seq)


def unpad(full_seq: np.ndarray) -> np.ndarray:
    """Truncate a sequence at its first EOS (reference: pretrain.py:245-249)."""
    full_seq = np.asarray(full_seq)
    where = np.nonzero(full_seq == EOS)[0]
    length = int(where[0]) if where.size else full_seq.shape[0]
    return full_seq[:length]


def calculate_wer(pred_seq: Dict[str, list],
                  target_seq: Dict[str, list]) -> Tuple[float, Dict]:
    """Mean WER over ids; bar sequences joined by ' \\n = \\n '
    (reference: pretrain.py:216-227)."""
    wer_dict = {}
    for id_ in pred_seq:
        pred = " \n = \n ".join(idx2string(p) for p in pred_seq[id_])
        target = " \n = \n ".join(idx2string(t) for t in target_seq[id_])
        wer_dict[id_] = word_error_rate(target, pred)
    n = max(len(wer_dict), 1)
    return sum(wer_dict.values()) / n, wer_dict


def macro_f1(y_true: Sequence[int], y_pred: Sequence[int]) -> float:
    """sklearn f1_score(average='macro') semantics: per-class F1 over the
    union of observed classes, zero for empty classes."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    classes = np.union1d(np.unique(y_true), np.unique(y_pred))
    f1s = []
    for c in classes:
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom else 0.0)
    return float(np.mean(f1s)) if f1s else 0.0


def calculate_f1(pred: Dict[str, list],
                 target: Dict[str, list]) -> Tuple[float, Dict]:
    """Mean macro-F1 over ids (reference: pretrain.py:236-243)."""
    f1_dict = {id_: macro_f1(target[id_], pred[id_]) for id_ in pred}
    n = max(len(f1_dict), 1)
    return sum(f1_dict.values()) / n, f1_dict
