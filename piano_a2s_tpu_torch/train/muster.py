"""Native MUSTER-class score error rate (11 components).

A copy of piano_a2s_tpu/train/muster.py for the port: the same error rates
on the same MusicXML pairs.

The reference pipes exported MusicXML pairs through the external MUSTER
tool (`./MUSTER/evaluate_XML_voicePlus.sh`, reference: evaluate.py:137-163)
and averages the 11 tab-separated error rates it prints. The tool (shell +
binary) is not vendored by the reference and is absent from this image, so
— exactly like the native MV2H scorer (train/mv2h.py) — this module
implements the metric natively behind the same interface; the external
script remains canonical whenever it is present (evaluate_offline.
get_muster_er picks the engine once per run).

Component inventory (the MUSTER metric of Cogliati & Duan, "A metric for
music notation transcription accuracy", ISMIR 2017: score-level error
rates over aligned notation elements — barlines, clefs, key/time
signatures, notes with spelling/duration/stem/staff attributes, rests):

    index  component          error counted
    0      barline            barline (measure-boundary) positions present
                              in exactly one score
    1      clef               per-(part, measure) active-clef mismatches
    2      key_signature      per-(part, measure) active key-fifths
                              mismatches
    3      time_signature     per-(part, measure) active time-signature
                              mismatches
    4      note               note-level edit distance (sub+del+ins) after
                              per-part alignment on (onset order, pitch)
    5      note_spelling      aligned same-pitch notes spelled differently
                              (step/alter enharmonics)
    6      note_duration      aligned notes with different notated duration
    7      stem_direction     aligned notes whose engraved stem direction
                              differs (voice-1-up/voice-2-down in
                              two-voice measures, else by staff midline)
    8      staff_assignment   aligned notes placed on a different staff
    9      rest               rest-level edit distance per part (aligned
                              on measure index)
    10     rest_duration      aligned rests with different notated duration

Every rate is normalized by the TARGET's element count for that component
(`max(count, 1)`); rates can exceed 1 when the prediction inserts more
elements than the target has, matching the external tool's behavior of
unbounded error rates. Alignments are Needleman-Wunsch (unit
substitution/indel costs) — deterministic and order-preserving, the same
family of alignment the published metric uses.

The parser reads the MusicXML subset our exporter writes (score-partwise,
<attributes> with key/time/clef carried forward, <backup> voices, <chord/>
notes) — which is standard-conformant MusicXML, so scores from other
writers parse too as long as they stick to score-partwise basics.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np

MUSTER_COMPONENTS = [
    "barline", "clef", "key_signature", "time_signature", "note",
    "note_spelling", "note_duration", "stem_direction",
    "staff_assignment", "rest", "rest_duration",
]


@dataclasses.dataclass
class XNote:
    """One notated note or rest as read from MusicXML."""
    onset: Fraction              # whole-note units from the part start
    duration: Fraction           # notated duration (whole-note units)
    midi: Optional[int]          # None = rest
    step: str = ""
    alter: int = 0
    octave: int = 4
    voice: int = 1
    staff: int = 0               # part index (piano grand staff = 2 parts)
    measure: int = 0
    two_voice_measure: bool = False
    clef: str = "treble"
    # Tie flags (parsed for consumers like the native EPR renderer; the
    # MUSTER components don't use them).
    tie_start: bool = False
    tie_stop: bool = False


@dataclasses.dataclass
class XScore:
    notes: List[XNote]                        # all parts, notes + rests
    # per (part, measure): active clef / key fifths / (beats, beat_type)
    clefs: List[List[str]]
    keys: List[List[int]]
    times: List[List[Tuple[int, int]]]
    barlines: List[List[Fraction]]            # per part: measure starts

    @property
    def n_parts(self) -> int:
        return len(self.clefs)


_STEP_MIDI = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def parse_musicxml(path: str) -> XScore:
    """Parse a score-partwise MusicXML file into an XScore."""
    root = ET.parse(path).getroot()
    notes: List[XNote] = []
    clefs, keys, times, barlines = [], [], [], []
    for p_idx, part in enumerate(root.iter("part")):
        divisions = 1
        clef, fifths, tsig = "treble", 0, (4, 4)
        p_clefs: List[str] = []
        p_keys: List[int] = []
        p_times: List[Tuple[int, int]] = []
        p_bars: List[Fraction] = []
        measure_start = Fraction(0)
        part_notes: List[XNote] = []
        for m_idx, measure in enumerate(part.iter("measure")):
            attrs = measure.find("attributes")
            if attrs is not None:
                d = attrs.find("divisions")
                if d is not None:
                    divisions = int(d.text)
                f = attrs.find("key/fifths")
                if f is not None:
                    fifths = int(f.text)
                b = attrs.find("time/beats")
                bt = attrs.find("time/beat-type")
                if b is not None and bt is not None:
                    tsig = (int(b.text), int(bt.text))
                sign = attrs.find("clef/sign")
                if sign is not None:
                    clef = "bass" if sign.text == "F" else "treble"
            p_clefs.append(clef)
            p_keys.append(fifths)
            p_times.append(tsig)
            p_bars.append(measure_start)
            cursor = Fraction(0)
            last_onset = Fraction(0)
            m_notes: List[XNote] = []
            m_voices = set()
            for el in measure:
                if el.tag == "backup":
                    cursor -= Fraction(int(el.find("duration").text),
                                       4 * divisions)
                elif el.tag == "forward":
                    cursor += Fraction(int(el.find("duration").text),
                                       4 * divisions)
                elif el.tag == "note":
                    dur = Fraction(int(el.find("duration").text),
                                   4 * divisions)
                    in_chord = el.find("chord") is not None
                    onset = last_onset if in_chord else cursor
                    if not in_chord:
                        last_onset = cursor
                        cursor += dur
                    v = el.find("voice")
                    voice = int(v.text) if v is not None else 1
                    m_voices.add(voice)
                    pitch = el.find("pitch")
                    if pitch is None:
                        n = XNote(measure_start + onset, dur, None,
                                  voice=voice, staff=p_idx, measure=m_idx,
                                  clef=clef)
                    else:
                        step = pitch.find("step").text
                        alt = pitch.find("alter")
                        alter = int(alt.text) if alt is not None else 0
                        octv = int(pitch.find("octave").text)
                        midi = 12 * (octv + 1) + _STEP_MIDI[step] + alter
                        tie_types = {t.get("type")
                                     for t in el.findall("tie")}
                        n = XNote(measure_start + onset, dur, midi,
                                  step=step, alter=alter, octave=octv,
                                  voice=voice, staff=p_idx, measure=m_idx,
                                  clef=clef,
                                  tie_start="start" in tie_types,
                                  tie_stop="stop" in tie_types)
                    m_notes.append(n)
            if len(m_voices) > 1:
                for n in m_notes:
                    n.two_voice_measure = True
            part_notes.extend(m_notes)
            measure_start += Fraction(*tsig) if tsig[1] else Fraction(1)
        clefs.append(p_clefs)
        keys.append(p_keys)
        times.append(p_times)
        barlines.append(p_bars)
        notes.extend(part_notes)
    return XScore(notes, clefs, keys, times, barlines)


def stem_direction(n: XNote) -> str:
    """Engraved stem direction under standard piano engraving rules:
    voice 1 up / voice 2 down in two-voice measures; otherwise by the
    staff midline (B4 treble, D3 bass)."""
    if n.two_voice_measure:
        return "up" if n.voice == 1 else "down"
    midline = 71 if n.clef == "treble" else 50
    return "up" if (n.midi is not None and n.midi < midline) else "down"


def _align(a: list, b: list, match) -> Tuple[list, int]:
    """Needleman-Wunsch with unit sub/indel costs.

    Returns (matched index pairs, edit distance). `match(x, y)` defines a
    zero-cost substitution; matched pairs are exactly those."""
    n, m = len(a), len(b)
    dp = np.zeros((n + 1, m + 1), np.int32)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    ok = np.zeros((n, m), bool)
    for i in range(n):
        for j in range(m):
            ok[i, j] = match(a[i], b[j])
            dp[i + 1, j + 1] = min(dp[i, j] + (0 if ok[i, j] else 1),
                                   dp[i, j + 1] + 1, dp[i + 1, j] + 1)
    pairs = []
    i, j = n, m
    while i > 0 and j > 0:
        if ok[i - 1, j - 1] and dp[i, j] == dp[i - 1, j - 1]:
            pairs.append((i - 1, j - 1))
            i, j = i - 1, j - 1
        elif dp[i, j] == dp[i - 1, j - 1] + 1:
            i, j = i - 1, j - 1
        elif dp[i, j] == dp[i - 1, j] + 1:
            i -= 1
        else:
            j -= 1
    return pairs[::-1], int(dp[n, m])


def _rate(errors: float, target_count: int) -> float:
    return errors / max(target_count, 1)


def _grid_er(t_grid: List[list], p_grid: List[list]) -> float:
    """Per-(part, measure) attribute mismatch rate, target-normalized.
    Parts/measures beyond the shared shape count as errors."""
    total = sum(len(rows) for rows in t_grid)
    errors = 0
    for p in range(max(len(t_grid), len(p_grid))):
        t_rows = t_grid[p] if p < len(t_grid) else []
        p_rows = p_grid[p] if p < len(p_grid) else []
        for m in range(max(len(t_rows), len(p_rows))):
            if m >= len(t_rows) or m >= len(p_rows) \
                    or t_rows[m] != p_rows[m]:
                errors += 1
    return _rate(errors, total)


def native_muster_pair(target_xml: str, pred_xml: str) -> np.ndarray:
    """The 11 MUSTER error rates for one (target, prediction) XML pair,
    in MUSTER_COMPONENTS order."""
    t, p = parse_musicxml(target_xml), parse_musicxml(pred_xml)

    # 0: barlines — measure-start positions present in exactly one score
    # (union over parts; a grand staff's parts share boundaries).
    t_bars = set().union(*t.barlines) if t.barlines else set()
    p_bars = set().union(*p.barlines) if p.barlines else set()
    er_bar = _rate(len(t_bars ^ p_bars), len(t_bars))

    # 1-3: per-(part, measure) active attribute mismatches.
    er_clef = _grid_er(t.clefs, p.clefs)
    er_key = _grid_er(t.keys, p.keys)
    er_time = _grid_er(t.times, p.times)

    # 4-8: note alignment per part on (order, pitch).
    n_target = err_note = 0
    matched: List[Tuple[XNote, XNote]] = []
    for part in range(max(t.n_parts, p.n_parts)):
        t_notes = [n for n in t.notes
                   if n.staff == part and n.midi is not None]
        p_notes = [n for n in p.notes
                   if n.staff == part and n.midi is not None]
        pairs, dist = _align(t_notes, p_notes,
                             lambda x, y: x.midi == y.midi)
        n_target += len(t_notes)
        err_note += dist
        matched.extend((t_notes[i], p_notes[j]) for i, j in pairs)
    er_note = _rate(err_note, n_target)
    n_match = len(matched)
    er_spell = _rate(sum((a.step, a.alter) != (b.step, b.alter)
                         for a, b in matched), n_match)
    er_dur = _rate(sum(a.duration != b.duration for a, b in matched),
                   n_match)
    er_stem = _rate(sum(stem_direction(a) != stem_direction(b)
                        for a, b in matched), n_match)
    # 8: staff assignment — re-align the whole score on pitch only, so a
    # note moved to the other staff still matches and its placement is
    # judged (the per-part alignment above can't see cross-staff moves).
    t_all = sorted((n for n in t.notes if n.midi is not None),
                   key=lambda n: (n.onset, n.midi))
    p_all = sorted((n for n in p.notes if n.midi is not None),
                   key=lambda n: (n.onset, n.midi))
    pairs_all, _ = _align(t_all, p_all, lambda x, y: x.midi == y.midi)
    er_staff = _rate(sum(t_all[i].staff != p_all[j].staff
                         for i, j in pairs_all), len(pairs_all))

    # 9-10: rest alignment per part on the measure index.
    n_rest_t = err_rest = 0
    rest_matched: List[Tuple[XNote, XNote]] = []
    for part in range(max(t.n_parts, p.n_parts)):
        t_rests = [n for n in t.notes if n.staff == part and n.midi is None]
        p_rests = [n for n in p.notes if n.staff == part and n.midi is None]
        pairs, dist = _align(t_rests, p_rests,
                             lambda x, y: x.measure == y.measure)
        n_rest_t += len(t_rests)
        err_rest += dist
        rest_matched.extend((t_rests[i], p_rests[j]) for i, j in pairs)
    er_rest = _rate(err_rest, n_rest_t)
    er_rest_dur = _rate(sum(a.duration != b.duration
                            for a, b in rest_matched), len(rest_matched))

    return np.array([er_bar, er_clef, er_key, er_time, er_note, er_spell,
                     er_dur, er_stem, er_staff, er_rest, er_rest_dur])
