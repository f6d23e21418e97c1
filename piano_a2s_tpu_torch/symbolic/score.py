"""Structured score model + parser for flattened measure-wise kern text.

This is the backbone of the export path that replaces the reference's
external toolchain (tiefix -> hum2xml -> music21; reference:
data_processing/humdrum.py:841-891): model output tokens are decoded to
kern text, parsed here into a Score, then written as MusicXML / MIDI by
the sibling modules.

Kern semantics handled: durations (recip N = 1/N whole note, dot = x1.5,
including non-power-of-two recips like 3, 6, 12, 20, 96), chords
(space-separated), rests, ties ([ open, _ continue, ] close), fermatas,
two-voice passages (*^ / *v spine marks), null tokens ('.').
"""

from __future__ import annotations

import dataclasses
import re
from fractions import Fraction
from typing import List, Optional, Tuple

from .humdrum import kern_to_midi

NOTE_RE = re.compile(r"^(\[?)(\d+)(\.*)([a-gA-G]{1,4}[\-#]*|r+)(;?)([\]_]?)$")

_STEP_ALTER = {"c": ("C", 0), "d": ("D", 0), "e": ("E", 0), "f": ("F", 0),
               "g": ("G", 0), "a": ("A", 0), "b": ("B", 0)}


@dataclasses.dataclass
class Note:
    """One note or rest event. duration is in whole-note units."""
    duration: Fraction
    midi: Optional[int] = None      # None = rest
    step: str = ""                  # spelled letter (upper-case)
    alter: int = 0                  # -1 flat, +1 sharp
    octave: int = 4                 # scientific pitch octave
    tie_start: bool = False
    tie_continue: bool = False
    tie_stop: bool = False
    fermata: bool = False

    @property
    def is_rest(self) -> bool:
        return self.midi is None


@dataclasses.dataclass
class Chord:
    """Simultaneous notes in one voice (shared onset & duration)."""
    notes: List[Note]

    @property
    def duration(self) -> Fraction:
        return self.notes[0].duration if self.notes else Fraction(0)


@dataclasses.dataclass
class Measure:
    key_fifths: int = 0             # sharps (+) / flats (-)
    time_sig: Tuple[int, int] = (4, 4)
    voices: List[List[Chord]] = dataclasses.field(default_factory=list)
    # Per-voice start offset within the measure (whole-note units): a
    # voice created by a MID-MEASURE *^ split begins when the primary
    # voice had already sounded its pre-split notes, not at the measure
    # start. Missing entries mean offset 0.
    voice_offsets: List[Fraction] = dataclasses.field(default_factory=list)

    def voice_offset(self, v_idx: int) -> Fraction:
        return (self.voice_offsets[v_idx]
                if v_idx < len(self.voice_offsets) else Fraction(0))


@dataclasses.dataclass
class Part:
    measures: List[Measure] = dataclasses.field(default_factory=list)
    clef: str = "treble"            # 'treble' | 'bass'
    name: str = "Piano"


@dataclasses.dataclass
class Score:
    parts: List[Part] = dataclasses.field(default_factory=list)


def spelled_pitch(kern_pitch: str) -> Tuple[str, int, int, int]:
    """kern pitch -> (step, alter, octave, midi)."""
    alter = 0
    base = kern_pitch
    if base.endswith("#"):
        alter, base = 1, base[:-1]
    elif base.endswith("-"):
        alter, base = -1, base[:-1]
    letter = base[0]
    step = letter.upper()
    if letter.isupper():
        octave = 4 - len(base)
    else:
        octave = 3 + len(base)
    midi = kern_to_midi(kern_pitch)
    return step, alter, octave, midi


def parse_note(token: str) -> Optional[Note]:
    """One kern note/rest token -> Note, or None if malformed."""
    m = NOTE_RE.match(token)
    if not m:
        return None
    tie_open, recip, dots, pitch, fermata, tie_close = m.groups()
    base = Fraction(1, int(recip)) if int(recip) else Fraction(2)
    dur = base
    add = base
    for _ in dots:
        add = add / 2
        dur += add
    note = Note(duration=dur, fermata=bool(fermata))
    if not pitch.startswith("r"):
        step, alter, octave, midi = spelled_pitch(pitch)
        note.midi = midi
        note.step, note.alter, note.octave = step, alter, octave
        note.tie_start = tie_open == "["
        note.tie_continue = tie_close == "_"
        note.tie_stop = tie_close == "]"
    return note


def parse_chord(token: str) -> Optional[Chord]:
    notes = []
    for part in token.split(" "):
        if not part:
            continue
        n = parse_note(part)
        if n is None:
            return None
        notes.append(n)
    return Chord(notes) if notes else None


def parse_staff_kern(kern_text: str, keys: List[int],
                     time_sigs: List[str], clef: str = "treble",
                     strict: bool = False) -> Part:
    """Parse one staff's flattened kern (measures separated by '=' lines,
    voices via *^ / *v marks) into a Part.

    keys / time_sigs: per-measure key fifths and 'N/D' strings (the model's
    per-bar classifications). Malformed tokens are skipped unless strict.
    """
    part = Part(clef=clef)

    # Split into per-measure segments at barlines FIRST, so measures with
    # no content lines still occupy a slot (empty model-output bars must
    # not shift later bars' key/time signatures or staff alignment).
    segments: List[List[str]] = []
    cur_lines: List[str] = []
    saw_line = False
    for raw in kern_text.splitlines():
        line = raw.rstrip()
        if line.startswith("="):
            if saw_line or cur_lines:
                segments.append(cur_lines)
            # a barline before any line at all is an opener, not a measure
            cur_lines = []
            saw_line = True
            continue
        cur_lines.append(line)
        saw_line = True
    if any(line.strip() for line in cur_lines):
        segments.append(cur_lines)  # trailing measure without a barline

    for measure_idx, segment in enumerate(segments):
        k = keys[measure_idx] if measure_idx < len(keys) else 0
        ts = time_sigs[measure_idx] if measure_idx < len(time_sigs) \
            else "4/4"
        num, den = ts.split("/")
        measure = Measure(key_fifths=int(k),
                          time_sig=(int(num), int(den)),
                          voices=[[] for _ in range(2)],
                          voice_offsets=[Fraction(0), Fraction(0)])
        v0_time = Fraction(0)  # primary voice's elapsed time this measure
        for line in segment:
            if not line:
                continue
            if line.startswith("*"):
                # A MID-measure *^ split: the new (second) voice enters at
                # the time the primary voice has already consumed — not at
                # the measure start (a split carried over from an earlier
                # measure leaves the offset at 0).
                if "*^" in line.split("\t") and not measure.voices[1]:
                    measure.voice_offsets[1] = v0_time
                continue
            for v, col in enumerate(line.split("\t")[:2]):
                if col == "." or col == "":
                    continue
                chord = parse_chord(col)
                if chord is None:
                    if strict:
                        raise ValueError(
                            f"malformed kern token: {col!r}")
                    continue
                measure.voices[v].append(chord)
                if v == 0:
                    v0_time += chord.duration
        keep = [i for i, v in enumerate(measure.voices) if v]
        measure.voice_offsets = [measure.voice_offsets[i] for i in keep]
        measure.voices = [measure.voices[i] for i in keep]
        if not measure.voices:
            measure.voices = [[]]
            measure.voice_offsets = [Fraction(0)]
        part.measures.append(measure)
    return part


def timed_notes(part: Part):
    """All notes of a part with exact onset/offset times (whole-note
    Fractions): [(onset, offset, voice_idx, note)]. Measure starts advance
    by the nominal time-signature length (stretched if a voice overflows).
    """
    out = []
    measure_start = Fraction(0)
    for measure in part.measures:
        num, den = measure.time_sig
        measure_len = Fraction(num, den)
        voice_end = measure_start
        for v_idx, voice in enumerate(measure.voices):
            t = measure_start + measure.voice_offset(v_idx)
            for chord in voice:
                for note in chord.notes:
                    out.append((t, t + note.duration, v_idx, note))
                t += chord.duration
            voice_end = max(voice_end, t)
        measure_start += max(measure_len, voice_end - measure_start)
    return out


def repair_ties(part: Part) -> Part:
    """Tie sanity repair (replaces humextra `tiefix` on the export path).

    A legal tie chain is `[`, `_`*, `]` over same-pitch notes that are
    temporally ADJACENT (each link starts exactly where the previous one
    ends) — this follows ties across measures and across voice-count
    changes while never joining unrelated same-pitch notes. Repairs:
      - `_` / `]` whose onset doesn't continue an open tie -> stripped
      - `[` with no adjacent same-pitch continuation/close -> stripped
      - dangling `_` (no continuation) -> becomes `]`
    This handles ties cut at 5-bar chunk boundaries, the case humextra
    `tiefix` exists for (reference invokes it at humdrum.py:857).
    """
    by_pitch: dict = {}
    for onset, offset, v_idx, note in timed_notes(part):
        if not note.is_rest:
            by_pitch.setdefault(note.midi, []).append(
                (onset, offset, v_idx, note))
    for notes in by_pitch.values():
        notes.sort(key=lambda x: (x[0], x[2]))
        open_until = None  # offset where an open tie expects its next link
        for i, (onset, offset, _, note) in enumerate(notes):
            if note.tie_continue or note.tie_stop:
                if open_until is None or onset != open_until:
                    note.tie_continue = note.tie_stop = False
            if note.tie_stop:
                open_until = None
            if note.tie_start or note.tie_continue:
                has_link = any(
                    o2 == offset and (n2.tie_continue or n2.tie_stop)
                    for (o2, _, _, n2) in notes[i + 1:])
                if has_link:
                    open_until = offset
                else:
                    if note.tie_continue:
                        note.tie_continue, note.tie_stop = False, True
                    note.tie_start = False
                    open_until = None
    return part
