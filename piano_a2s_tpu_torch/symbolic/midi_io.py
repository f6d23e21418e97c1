"""Standard MIDI File reader + event-level editing (tempo scaling etc.).

A copy of piano_a2s_tpu/symbolic/midi_io.py for the port (the native MV2H
scorer reads the exported MIDI through ``read_midi``). Self-contained SMF
parser complementing the writer in midi.py; replaces the
reference's mido/pretty_midi usage in the offline pipeline
(reference: utilities.py:280-345 MIDIProcess, data_processing/render.py:532).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple


@dataclasses.dataclass
class MidiEvent:
    delta: int            # delta ticks from previous event in the track
    status: int           # status byte (0x80-0xFF)
    data: bytes           # event payload (without status)

    @property
    def kind(self) -> str:
        hi = self.status & 0xF0
        if self.status == 0xFF:
            return "meta"
        return {0x80: "note_off", 0x90: "note_on", 0xA0: "polytouch",
                0xB0: "control_change", 0xC0: "program_change",
                0xD0: "aftertouch", 0xE0: "pitchwheel"}.get(hi, "other")


@dataclasses.dataclass
class MidiFile:
    ticks_per_beat: int
    tracks: List[List[MidiEvent]]

    # -- analysis -----------------------------------------------------------

    def tempo_us(self) -> int:
        for track in self.tracks:
            for ev in track:
                if ev.status == 0xFF and ev.data[:1] == b"\x51":
                    return int.from_bytes(ev.data[1:4], "big")
        return 500000

    def length_seconds(self) -> float:
        """Duration to the last event (single-tempo assumption, matching
        mido's MidiFile.length for these files)."""
        spt = self.tempo_us() / 1e6 / self.ticks_per_beat
        longest = 0
        for track in self.tracks:
            t = sum(ev.delta for ev in track)
            longest = max(longest, t)
        return longest * spt

    def notes(self) -> List[Tuple[float, float, int, int]]:
        """(onset_sec, offset_sec, pitch, velocity) pairs; velocity is the
        note-ON velocity."""
        spt = self.tempo_us() / 1e6 / self.ticks_per_beat
        out = []
        for track in self.tracks:
            t = 0
            active = {}
            for ev in track:
                t += ev.delta
                if ev.kind == "note_on" and len(ev.data) >= 2 \
                        and ev.data[1] > 0:
                    active.setdefault(ev.data[0], []).append(
                        (t, ev.data[1]))
                elif ev.kind in ("note_off", "note_on") \
                        and len(ev.data) >= 2:
                    starts = active.get(ev.data[0])
                    if starts:
                        start, velocity = starts.pop(0)
                        out.append((start * spt, t * spt, ev.data[0],
                                    velocity))
        return sorted(out)


def _read_vlq(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def read_midi(path: str) -> MidiFile:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"MThd":
        raise ValueError("not a MIDI file")
    _, _, n_tracks, division = struct.unpack(">IHHH", raw[4:14])
    pos = 14
    tracks = []
    for _ in range(n_tracks):
        if raw[pos:pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        length = struct.unpack(">I", raw[pos + 4:pos + 8])[0]
        end = pos + 8 + length
        p = pos + 8
        events: List[MidiEvent] = []
        running = 0
        while p < end:
            delta, p = _read_vlq(raw, p)
            status = raw[p]
            if status & 0x80:
                p += 1
                running = status
            else:
                status = running
            if status == 0xFF:
                meta_type = raw[p]
                ln, p2 = _read_vlq(raw, p + 1)
                # store as: type byte + payload (length re-derived on write)
                data = bytes([meta_type]) + raw[p2:p2 + ln]
                p = p2 + ln
                events.append(MidiEvent(delta, 0xFF, data))
            elif status in (0xF0, 0xF7):
                ln, p2 = _read_vlq(raw, p)
                events.append(MidiEvent(delta, status, raw[p:p2 + ln]))
                p = p2 + ln
            else:
                n_data = 1 if (status & 0xF0) in (0xC0, 0xD0) else 2
                events.append(MidiEvent(delta, status, raw[p:p + n_data]))
                p += n_data
        tracks.append(events)
        pos = end
    return MidiFile(ticks_per_beat=division, tracks=tracks)


def write_midi_file(midi: MidiFile, path: str) -> None:
    def vlq(value: int) -> bytes:
        out = [value & 0x7F]
        value >>= 7
        while value:
            out.append((value & 0x7F) | 0x80)
            value >>= 7
        return bytes(reversed(out))

    chunks = [b"MThd" + struct.pack(">IHHH", 6, 1, len(midi.tracks),
                                    midi.ticks_per_beat)]
    for track in midi.tracks:
        data = bytearray()
        for ev in track:
            data += vlq(max(ev.delta, 0))
            if ev.status == 0xFF:
                meta_type = ev.data[0]
                payload = ev.data[1:]
                data += bytes([0xFF, meta_type]) + vlq(len(payload)) \
                    + payload
            else:
                data += bytes([ev.status]) + ev.data
        if not (len(track) and track[-1].status == 0xFF
                and track[-1].data[:1] == b"\x2f"):
            data += vlq(0) + b"\xff\x2f\x00"
        chunks.append(b"MTrk" + struct.pack(">I", len(data)) + bytes(data))
    with open(path, "wb") as f:
        f.write(b"".join(chunks))


class MIDIProcess:
    """MIDI cleanup + random tempo scaling for the synthesis pipeline
    (reference: utilities.py:280-345): trims the final pedal-off, removes
    initial silence, scales event times by a random factor in [0.85, 1.15]
    clamped so total length lands in [4 s, 12 s] (deterministic for
    valid/test)."""

    def __init__(self, midi_path: str, split: str = "train",
                 rng=None):
        assert split in ("train", "valid", "test")
        self.midi = read_midi(midi_path)
        self.split = split
        import numpy as np
        self.rng = rng if rng is not None else np.random

    def cut_last_pedal(self) -> None:
        for track in self.midi.tracks:
            if len(track) >= 2:
                ev = track[-2]
                if ev.kind == "control_change" and len(ev.data) >= 2 \
                        and ev.data[0] == 64 and ev.data[1] == 0 \
                        and (ev.status & 0x0F) == 0:
                    ev.delta = 0

    def cut_initial_blank(self) -> None:
        total_before = 0
        found = False
        for track in self.midi.tracks:
            acc = 0
            for ev in track:
                if not found:
                    acc += ev.delta
                    is_note = (ev.kind == "note_on" and len(ev.data) >= 2
                               and ev.data[1] > 0)
                    is_cc = (ev.kind == "control_change"
                             and len(ev.data) >= 2 and ev.data[1] > 0)
                    if is_note or is_cc:
                        found = True
                        total_before = acc - ev.delta
                        ev.delta = 0
                else:
                    ev.delta -= total_before
                    break

    def random_scaling(self, scale_range=(0.85, 1.15)
                       ) -> Tuple[Optional[float], float]:
        original = self.midi.length_seconds()
        if original <= 0:
            return None, original
        lower = max(scale_range[0], 4.0 / original)
        upper = min(scale_range[1], 12.0 / original)
        if lower > upper:
            return None, original
        if self.split in ("valid", "test"):
            scaling = lower if lower > 1 else (upper if upper < 1 else 1.0)
        else:
            scaling = float(self.rng.uniform(lower, upper))
        for track in self.midi.tracks:
            for ev in track:
                if ev.kind in ("note_on", "note_off", "control_change",
                               "program_change"):
                    ev.delta = int(ev.delta * scaling)
        return scaling, original

    def process(self, out_path: str) -> Tuple[Optional[float], float]:
        self.cut_last_pedal()
        self.cut_initial_blank()
        scaling, original = self.random_scaling()
        if scaling is not None:
            write_midi_file(self.midi, out_path)
        return scaling, original
