"""Model output -> score files (MusicXML + MIDI).

Copy of piano_a2s_tpu/symbolic/export.py's export path: inverts token
sequences to kern text, parses to a Score, repairs ties, and writes
MusicXML/MIDI (replaces the reference's get_xml_from_target + external
tiefix/hum2xml/music21 pipeline; reference: data_processing/humdrum.py:
841-891, evaluate.py:18-44).

Target structure (per measure): ``[key_fifths, time_sig_str, lower_tokens,
upper_tokens]``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .score import Score, parse_staff_kern, repair_ties
from .vocab import LabelsMultiple

_default_labels = LabelsMultiple(extended=True)


def _dedupe_chords(line: str) -> str:
    """Drop duplicate notes within each chord (reference:
    humdrum.py:821-839; order-preserving here)."""
    cols = []
    for chord in line.split("\t"):
        notes = [n for n in dict.fromkeys(chord.split(" ")) if n]
        cols.append(" ".join(notes) if notes else chord)
    return "\t".join(cols)


def tokens_to_kern(measures: Sequence[Sequence[int]],
                   labels: Optional[LabelsMultiple] = None) -> str:
    """Per-measure token id lists -> flattened kern text with '=' barlines."""
    labels = labels or _default_labels
    out: List[str] = []
    for measure in measures:
        text = "".join(labels.decode(measure))
        out.append("\n".join(_dedupe_chords(ln)
                             for ln in text.splitlines()))
    return "\n=\n".join(out) + "\n="


def get_score_from_target(target: Sequence,
                          labels: Optional[LabelsMultiple] = None) -> Score:
    """[[key, time_sig, lower_tokens, upper_tokens], ...] -> Score with
    treble upper / bass lower piano parts."""
    labels = labels or _default_labels
    keys = [int(m[0]) for m in target]
    time_sigs = [str(m[1]) for m in target]
    lower_kern = tokens_to_kern([m[2] for m in target], labels)
    upper_kern = tokens_to_kern([m[3] for m in target], labels)
    upper = parse_staff_kern(upper_kern, keys, time_sigs, clef="treble")
    lower = parse_staff_kern(lower_kern, keys, time_sigs, clef="bass")
    repair_ties(upper)
    repair_ties(lower)
    return Score(parts=[upper, lower])


def export_target(target, musicxml_path: Optional[str] = None,
                  midi_path: Optional[str] = None,
                  labels: Optional[LabelsMultiple] = None) -> Score:
    score = get_score_from_target(target, labels)
    if musicxml_path:
        from .musicxml import write_musicxml
        write_musicxml(score, musicxml_path)
    if midi_path:
        from .midi import write_midi
        write_midi(score, midi_path)
    return score
