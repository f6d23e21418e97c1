"""MusicXML (score-partwise 3.1) writer, self-contained.

Replaces the reference's hum2xml + music21 export (reference:
humdrum.py:862-891, evaluate.py:31). Emits two piano parts (upper/treble,
lower/bass) with per-measure key/time signatures, chords, rests, ties,
fermatas, and up-to-two voices per measure (voice 2 via <backup>).
"""

from __future__ import annotations

from fractions import Fraction
from math import lcm
from typing import List
from xml.sax.saxutils import escape

from .score import Chord, Measure, Part, Score

_TYPE_BY_RECIP = {1: "whole", 2: "half", 4: "quarter", 8: "eighth",
                  16: "16th", 32: "32nd", 64: "64th", 128: "128th"}


def _divisions_for(score: Score) -> int:
    """Smallest divisions-per-quarter making every duration integral."""
    div = 1
    for part in score.parts:
        for m in part.measures:
            for voice in m.voices:
                for chord in voice:
                    for n in chord.notes:
                        q = n.duration * 4
                        div = lcm(div, q.denominator)
    return div


def _note_xml(note, divisions: int, voice_num: int, in_chord: bool) -> str:
    dur = int(note.duration * 4 * divisions)
    lines = ["    <note>"]
    if in_chord:
        lines.append("      <chord/>")
    if note.is_rest:
        lines.append("      <rest/>")
    else:
        lines.append("      <pitch>")
        lines.append(f"        <step>{note.step}</step>")
        if note.alter:
            lines.append(f"        <alter>{note.alter}</alter>")
        lines.append(f"        <octave>{note.octave}</octave>")
        lines.append("      </pitch>")
    lines.append(f"      <duration>{dur}</duration>")
    ties = []
    if note.tie_stop or note.tie_continue:
        ties.append('      <tie type="stop"/>')
    if note.tie_start or note.tie_continue:
        ties.append('      <tie type="start"/>')
    lines.extend(ties)
    lines.append(f"      <voice>{voice_num}</voice>")
    q = note.duration * 4
    recip_fraction = Fraction(4, 1) / q
    base = Fraction(4, 1) / (q / Fraction(3, 2))
    if recip_fraction.denominator == 1 \
            and int(recip_fraction) in _TYPE_BY_RECIP:
        lines.append(
            f"      <type>{_TYPE_BY_RECIP[int(recip_fraction)]}</type>")
    elif base.denominator == 1 and int(base) in _TYPE_BY_RECIP:
        lines.append(f"      <type>{_TYPE_BY_RECIP[int(base)]}</type>")
        lines.append("      <dot/>")
    notations = []
    if note.tie_stop or note.tie_continue:
        notations.append('        <tied type="stop"/>')
    if note.tie_start or note.tie_continue:
        notations.append('        <tied type="start"/>')
    if note.fermata:
        notations.append("        <fermata/>")
    if notations:
        lines.append("      <notations>")
        lines.extend(notations)
        lines.append("      </notations>")
    lines.append("    </note>")
    return "\n".join(lines)


def _voice_xml(voice: List[Chord], divisions: int, voice_num: int) -> str:
    out = []
    for chord in voice:
        for i, note in enumerate(chord.notes):
            out.append(_note_xml(note, divisions, voice_num, in_chord=i > 0))
    return "\n".join(out)


def _measure_xml(measure: Measure, divisions: int, index: int,
                 clef: str, first: bool, prev: Measure | None) -> str:
    lines = [f'  <measure number="{index}">']
    attrs = []
    if first:
        attrs.append(f"      <divisions>{divisions}</divisions>")
    if first or (prev and prev.key_fifths != measure.key_fifths):
        attrs.append("      <key>")
        attrs.append(f"        <fifths>{measure.key_fifths}</fifths>")
        attrs.append("      </key>")
    if first or (prev and prev.time_sig != measure.time_sig):
        num, den = measure.time_sig
        attrs.append("      <time>")
        attrs.append(f"        <beats>{num}</beats>")
        attrs.append(f"        <beat-type>{den}</beat-type>")
        attrs.append("      </time>")
    if first:
        sign, line_n = ("G", 2) if clef == "treble" else ("F", 4)
        attrs.append("      <clef>")
        attrs.append(f"        <sign>{sign}</sign>")
        attrs.append(f"        <line>{line_n}</line>")
        attrs.append("      </clef>")
    if attrs:
        lines.append("    <attributes>")
        lines.extend(attrs)
        lines.append("    </attributes>")
    voices = measure.voices or [[]]
    lines.append(_voice_xml(voices[0], divisions, 1))
    if len(voices) > 1 and voices[1]:
        dur_v1 = sum((c.duration for c in voices[0]), Fraction(0))
        # A voice entering mid-measure (*^ split after some primary-voice
        # notes; Measure.voice_offsets) backs up only to its entry point.
        backup = int((dur_v1 - measure.voice_offset(1)) * 4 * divisions)
        if backup > 0:
            lines.append("    <backup>")
            lines.append(f"      <duration>{backup}</duration>")
            lines.append("    </backup>")
        lines.append(_voice_xml(voices[1], divisions, 2))
    lines.append("  </measure>")
    return "\n".join(line for line in lines if line)


def _part_xml(part: Part, pid: str, divisions: int) -> str:
    lines = [f'  <part id="{pid}">'.replace("  <part", "<part")]
    prev = None
    for i, measure in enumerate(part.measures):
        lines.append(_measure_xml(measure, divisions, i + 1, part.clef,
                                  first=(i == 0), prev=prev))
        prev = measure
    lines.append("</part>")
    return "\n".join(lines)


def score_to_musicxml(score: Score) -> str:
    divisions = _divisions_for(score)
    parts_list = []
    parts_body = []
    for i, part in enumerate(score.parts):
        pid = f"P{i + 1}"
        parts_list.append(
            f'    <score-part id="{pid}">\n'
            f"      <part-name>{escape(part.name)}</part-name>\n"
            f"    </score-part>")
        parts_body.append(_part_xml(part, pid, divisions))
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        "<!DOCTYPE score-partwise PUBLIC "
        '"-//Recordare//DTD MusicXML 3.1 Partwise//EN" '
        '"http://www.musicxml.org/dtds/partwise.dtd">\n'
        '<score-partwise version="3.1">\n'
        "  <part-list>\n" + "\n".join(parts_list) + "\n  </part-list>\n"
        + "\n".join(parts_body) + "\n</score-partwise>\n")


def write_musicxml(score: Score, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(score_to_musicxml(score))
