"""Minimal Standard MIDI File writer (type 1), self-contained.

Replaces the reference's music21 MIDI export on the evaluation path
(reference: evaluate.py:31-35 writes score.write('midi')). Ties are merged
into single sustained notes; each part becomes one track; tempo fixed at
120 BPM (music21's default for scores without tempo marks), with time- and
key-signature meta events.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import List, Tuple

from .score import Part, Score

TICKS_PER_QUARTER = 480
DEFAULT_TEMPO_US = 500000  # 120 BPM


def _vlq(value: int) -> bytes:
    """Variable-length quantity."""
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return tag + struct.pack(">I", len(data)) + data


def _events_for_part(part: Part) -> List[Tuple[int, int, int]]:
    """(onset_ticks, duration_ticks, midi) with ties merged.

    Tie links are matched by pitch AND exact temporal adjacency (the
    continuation must start where the open note ends), following ties
    across measures and voice-count changes without joining unrelated
    same-pitch notes."""
    from .score import timed_notes
    events: List[List[int]] = []
    active: dict = {}  # pitch -> [event, expected_next_onset]
    for onset, offset, _, note in sorted(timed_notes(part),
                                         key=lambda x: (x[0], x[2])):
        if note.is_rest:
            continue
        onset_ticks = int(onset * 4 * TICKS_PER_QUARTER)
        dur_ticks = int((offset - onset) * 4 * TICKS_PER_QUARTER)
        key = note.midi
        entry = active.get(key)
        if (note.tie_continue or note.tie_stop) and entry is not None \
                and entry[1] == onset:
            entry[0][1] += dur_ticks
            if note.tie_stop:
                del active[key]
            else:
                entry[1] = offset
            continue
        ev = [onset_ticks, dur_ticks, note.midi]
        events.append(ev)
        if note.tie_start or note.tie_continue:
            active[key] = [ev, offset]
    return [tuple(e) for e in events]


def _track_bytes(events: List[Tuple[int, int, int]],
                 meta: bytes = b"") -> bytes:
    msgs: List[Tuple[int, bytes]] = []
    for onset, dur, midi in events:
        midi = max(0, min(127, midi))
        msgs.append((onset, bytes([0x90, midi, 80])))
        msgs.append((onset + max(dur, 1), bytes([0x80, midi, 0])))
    msgs.sort(key=lambda m: (m[0], m[1][0]))  # note-offs before note-ons
    data = bytearray(meta)
    t = 0
    for abs_t, msg in msgs:
        data += _vlq(abs_t - t) + msg
        t = abs_t
    data += _vlq(0) + b"\xff\x2f\x00"  # end of track
    return bytes(data)


def write_midi(score: Score, path: str) -> None:
    n_tracks = 1 + len(score.parts)
    header = _chunk(b"MThd", struct.pack(">HHH", 1, n_tracks,
                                         TICKS_PER_QUARTER))
    # Conductor track: tempo + first measure's time/key signature.
    meta = bytearray()
    meta += _vlq(0) + b"\xff\x51\x03" + struct.pack(">I", DEFAULT_TEMPO_US)[1:]
    if score.parts and score.parts[0].measures:
        m0 = score.parts[0].measures[0]
        num, den = m0.time_sig
        den_pow = max(0, den.bit_length() - 1)
        meta += _vlq(0) + bytes([0xFF, 0x58, 0x04, num, den_pow, 24, 8])
        sf = m0.key_fifths % 256
        meta += _vlq(0) + bytes([0xFF, 0x59, 0x02, sf, 0])
    conductor = bytes(meta) + _vlq(0) + b"\xff\x2f\x00"
    tracks = [_chunk(b"MTrk", conductor)]
    for part in score.parts:
        tracks.append(_chunk(b"MTrk", _track_bytes(_events_for_part(part))))
    with open(path, "wb") as f:
        f.write(header + b"".join(tracks))
