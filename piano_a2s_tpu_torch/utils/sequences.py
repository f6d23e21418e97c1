"""Token-sequence duration accounting, a copy of
piano_a2s_tpu/utils/sequences.py (reference: utilities.py:16-25,
256-278): sums the quarter-note duration of the FIRST note of each line of
a tokenized kern sequence (chords share the line's duration)."""

from __future__ import annotations

from typing import Sequence

from ..symbolic.vocab import LabelsMultiple

_labels = LabelsMultiple(extended=True)

_DURATIONS = ["1", "1.", "2", "2.", "4", "4.", "8", "8.", "16", "16.",
              "32", "32.", "64", "64.", "3", "6", "12", "24", "48",
              "96", "128", "20", "40", "176", "112"]
_QUARTERS = [4, 6, 2, 3, 1, 3 / 2, 1 / 2, 3 / 4, 1 / 4, 3 / 8, 1 / 8,
             3 / 16, 1 / 16, 3 / 32, 4 / 3, 2 / 3, 1 / 3, 1 / 6, 1 / 12,
             1 / 24, 1 / 32, 1 / 5, 1 / 10, 1 / 44, 1 / 28]

DURATION_TOKENS = [_labels.labels_map[d] for d in _DURATIONS]
TOKEN_TO_QUARTER = dict(zip(DURATION_TOKENS, _QUARTERS))
SPLIT_TOKEN = _labels.labels_map["\n"]
EOS_TOKEN = _labels.labels_map["<eos>"]


def get_sequence_duration(sequence: Sequence[int]) -> float:
    """Quarter-note duration of a tokenized kern sequence."""
    sequence = [int(t) for t in sequence]
    quarter = 0.0
    new_line = True
    for token in sequence:
        if token == EOS_TOKEN:
            break
        if token == SPLIT_TOKEN:
            new_line = True
        if token in TOKEN_TO_QUARTER:
            if new_line:
                quarter += TOKEN_TO_QUARTER[token]
                new_line = False
    return quarter
