"""Kern pitch helper: the one function of piano_a2s_tpu/symbolic/humdrum.py
that score parsing needs (the port does not tokenize kern files)."""

from __future__ import annotations

_KERN_BASE_MIDI = {
    "c": 60, "d": 62, "e": 64, "f": 65, "g": 67, "a": 69, "b": 71,
    "C": 48, "D": 50, "E": 52, "F": 53, "G": 55, "A": 57, "B": 59,
}


def kern_to_midi(kern_note: str) -> int:
    """Kern pitch spelling -> MIDI number: letter case picks the register
    direction, letter repetition counts octaves (reference:
    humdrum.py:600-622)."""
    accidental = 0
    if kern_note.endswith("#"):
        accidental, kern_note = 1, kern_note[:-1]
    elif kern_note.endswith("-"):
        accidental, kern_note = -1, kern_note[:-1]
    octaves = len(kern_note) - 1
    step = -12 * octaves if kern_note[0].isupper() else 12 * octaves
    return _KERN_BASE_MIDI[kern_note[0]] + accidental + step
