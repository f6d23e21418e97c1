"""The model's kern sub-token vocabulary, :class:`LabelsMultiple`.

Copy of the class of piano_a2s_tpu/symbolic/vocab.py (behavior-compatible
with the reference: data_processing/humdrum.py:70-131): 148 base + 25
extended = 173 symbols (durations, pitch names, rest, ties, fermata,
structural separators, ``<sos>/<eos>/<pad>``). The pitch table is generated
from the kern pitch "ladder" (flat / natural / sharp per letter per octave
register); ``<pad>`` = 147, ``<sos>`` = 145, ``<eos>`` = 146.
"""

from __future__ import annotations

import re
from typing import Dict, List

# Durations in kern "recip" notation. Powers of two (+dotted), then the
# triplet-family denominators. (reference: humdrum.py:75)
_BASE_DURATIONS: List[str] = [
    "1", "1.", "2", "2.", "4", "4.", "8", "8.", "16", "16.",
    "32", "32.", "64", "64.", "3", "6", "12", "24", "48", "96",
]
# Rare denominators only present in the extended vocabulary.
# (reference: humdrum.py:89)
_EXT_DURATIONS: List[str] = ["128", "20", "40", "176", "112"]

_REGISTERS = ["CCC", "CC", "C", "c", "cc", "ccc", "cccc"]
_LETTERS = "CDEFGAB"
_ACCIDENTALS = ("-", "", "#")


def _pitch_ladder() -> List[str]:
    """All kern pitch spellings CCC- .. bbbb#, ascending by letter name."""
    out = []
    for reg in _REGISTERS:
        lower = reg[0].islower()
        n = len(reg)
        for letter in _LETTERS:
            name = (letter.lower() if lower else letter) * n
            for acc in _ACCIDENTALS:
                out.append(name + acc)
    return out


def _pitch_tables() -> tuple[List[str], List[str]]:
    """(base_pitches, extended_pitches) matching the reference's id order.

    The base table spans BBB# .. ffff (without CC-); the extended table adds
    the sub-contra register CCC .. BBB plus CC-. (reference: humdrum.py:76-92)
    """
    ladder = _pitch_ladder()
    base = ladder[ladder.index("BBB#"): ladder.index("ffff") + 1]
    base.remove("CC-")
    ext = ladder[ladder.index("CCC"): ladder.index("BBB") + 1] + ["CC-"]
    return base, ext


_STRUCTURAL = ["r", ".", "[", "_", "]", ";", "\t", "\n", "<b>",
               "<sos>", "<eos>", "<pad>"]

# A note token: optional tie-open, duration digits + dots, pitch letters with
# accidentals (or rest), optional fermata, optional tie-continue/close.
# (reference: humdrum.py:110)
_NOTE_RE = re.compile(r"(\[?)(\d+\.*)([a-gA-Gr]{1,4}[\-#]*)(;?)([\]_]?)")


class LabelsMultiple:
    """Sub-token vocabulary: each note splits into up to 5 symbols."""

    def __init__(self, extended: bool = False):
        base_pitches, ext_pitches = _pitch_tables()
        self.labels: List[str] = (
            list(_BASE_DURATIONS) + base_pitches + list(_STRUCTURAL))
        if extended:
            self.labels.extend(_EXT_DURATIONS)
            self.labels.extend(ext_pitches)
        self.labels_map: Dict[str, int] = {
            c: i for i, c in enumerate(self.labels)}
        self.labels_map_inv: Dict[int, str] = {
            i: c for i, c in enumerate(self.labels)}

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def sos(self) -> int:
        return self.labels_map["<sos>"]

    @property
    def eos(self) -> int:
        return self.labels_map["<eos>"]

    @property
    def pad(self) -> int:
        return self.labels_map["<pad>"]

    def encode(self, text: str) -> List[int]:
        """Tokenize one measure of flattened kern text.

        Lines are spine columns joined by tabs; chords are notes joined by
        spaces. Each multi-char note is regex-split into its (tie-open,
        duration, pitch, fermata, tie-close) sub-tokens; chord members are
        joined with ``<b>``. (reference: humdrum.py:99-127)
        """
        tokens: List[int] = []
        for line in text.splitlines():
            for chord in line.split("\t"):
                for note in chord.split(" "):
                    if len(note) == 1:
                        tokens.append(self.labels_map[note])
                    else:
                        m = _NOTE_RE.fullmatch(note)
                        if not m:
                            raise ValueError(
                                f"Item {note} in {line} does not match")
                        for part in m.groups():
                            if part:
                                tokens.append(self.labels_map[part])
                    tokens.append(self.labels_map["<b>"])
                if tokens[-1] == self.labels_map["<b>"]:
                    tokens.pop()
                tokens.append(self.labels_map["\t"])
            tokens[-1] = self.labels_map["\n"]
        tokens.pop()
        return tokens

    def decode(self, tokens) -> List[str]:
        """Inverse of :meth:`encode`; ``<b>`` maps back to a space.

        Unknown ids are dropped (the reference filters falsy entries —
        label id 0 maps to the truthy string "1" and is kept).
        (reference: humdrum.py:129-131)
        """
        decoded = [self.labels_map_inv.get(int(t)) for t in tokens]
        return [s if s != "<b>" else " " for s in decoded if s]
