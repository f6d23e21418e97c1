"""Native expressive-performance renderer (EPR) — the no-tool fallback.

A copy of piano_a2s_tpu/data/epr_native.py for the port, on the port's
``symbolic/midi_io.py`` and ``train/muster.py``: for the same MusicXML it
writes the same MIDI bytes.

The reference renders ``midi_syn: epr`` training MIDI with an external
virtuosoNet checkout (reference: data_processing/render.py:395-455 — the
isgn model, composer-conditioned, latent z=0, i.e. the *mean* performance
for that composer). The checkout is not vendored there and is absent from
this image, so — following the same pattern as the native MV2H and MUSTER
scorers — this module provides a self-contained engine behind the exact
``epr_generate(xml_path, composer) -> midi_path`` contract that
``data.render.xml_to_midi`` injects. virtuosoNet remains canonical when a
checkout is present (``epr_engine: auto|virtuosonet|native``).

What "expressive" means here is the classic rule system (KTH
performance-rules tradition) rather than a learned model — deterministic
(z=0-like: no randomness; micro-deviations are content-hashed), and
composer-conditioned through a small style table:

  * **phrase-arch tempo**: the piece breathes in 4-bar phrases — each
    phrase starts slightly below tempo, accelerates through its middle,
    and relaxes into its end; a global arch does the same across the
    whole excerpt, and the final bar gets an extra ritardando.
  * **dynamics**: the same arch shapes velocity (mid-phrase loudest),
    plus metrical accents (downbeat > mid-bar strong beat > offbeat) and
    a pitch-height term (higher = slightly brighter).
  * **articulation**: a per-composer sounding-duration fraction
    (detached Bach/Haydn < legato Chopin/Rachmaninoff); ties merge into
    one continuous sounding note first.
  * **melody lead**: where both staves attack together, the upper staff
    leads by ~15 ms (the well-documented melody-lead effect).
  * **micro-timing**: a few ms of deterministic, content-derived onset
    scatter so simultaneous voices don't land sample-identical.

The output is a performance-format SMF (absolute expressive timing at a
fixed MIDI tempo) that feeds straight into ``MIDIProcess`` like a
virtuosoNet render would.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from ..symbolic.midi_io import MidiEvent, MidiFile, write_midi_file
from ..train.muster import XScore, parse_musicxml

# Per-composer style parameters. qpm: base quarter-note tempo;
# rubato: phrase/global arch depth (fraction of beat duration);
# rit: extra final-bar ritardando depth; art: sounding fraction of the
# notated duration; dyn: arch velocity swing (MIDI units); base_vel:
# centre velocity. The table covers every name in render.TRAIN_COMPOSERS /
# TEST_COMPOSERS; unknown composers get DEFAULT.
_STYLE: Dict[str, Dict[str, float]] = {
    "DEFAULT":      dict(qpm=100, rubato=0.06, rit=0.35, art=0.95,
                         dyn=10, base_vel=64, lead_ms=15.0),
    # Deadpan score rendering (the reference's composer=='score' draws
    # verovio score MIDI): exact notated timing, flat dynamics, no lead,
    # no micro-deviations — the no-verovio fallback for those chunks.
    "score":        dict(qpm=120, rubato=0.0, rit=0.0, art=1.0,
                         dyn=0, base_vel=64, lead_ms=0.0, deadpan=True),
    "Bach":         dict(qpm=96,  rubato=0.03, rit=0.25, art=0.84,
                         dyn=6,  base_vel=62, lead_ms=8.0),
    "Haydn":        dict(qpm=108, rubato=0.04, rit=0.25, art=0.88,
                         dyn=8,  base_vel=63, lead_ms=10.0),
    "Mozart":       dict(qpm=112, rubato=0.04, rit=0.30, art=0.90,
                         dyn=9,  base_vel=64, lead_ms=10.0),
    "Beethoven":    dict(qpm=104, rubato=0.06, rit=0.35, art=0.93,
                         dyn=14, base_vel=68, lead_ms=12.0),
    "Schubert":     dict(qpm=96,  rubato=0.07, rit=0.40, art=0.97,
                         dyn=11, base_vel=63, lead_ms=15.0),
    "Chopin":       dict(qpm=88,  rubato=0.11, rit=0.50, art=1.02,
                         dyn=13, base_vel=62, lead_ms=22.0),
    "Schumann":     dict(qpm=92,  rubato=0.09, rit=0.42, art=0.99,
                         dyn=12, base_vel=64, lead_ms=18.0),
    "Brahms":       dict(qpm=92,  rubato=0.08, rit=0.40, art=0.97,
                         dyn=12, base_vel=66, lead_ms=15.0),
    "Liszt":        dict(qpm=100, rubato=0.10, rit=0.45, art=0.96,
                         dyn=16, base_vel=68, lead_ms=18.0),
    "Debussy":      dict(qpm=84,  rubato=0.09, rit=0.45, art=1.04,
                         dyn=10, base_vel=58, lead_ms=20.0),
    "Ravel":        dict(qpm=92,  rubato=0.07, rit=0.40, art=1.00,
                         dyn=11, base_vel=60, lead_ms=16.0),
    "Rachmaninoff": dict(qpm=88,  rubato=0.09, rit=0.45, art=1.01,
                         dyn=15, base_vel=66, lead_ms=20.0),
    "Scriabin":     dict(qpm=90,  rubato=0.10, rit=0.45, art=1.00,
                         dyn=13, base_vel=63, lead_ms=20.0),
    "Prokofiev":    dict(qpm=112, rubato=0.04, rit=0.30, art=0.88,
                         dyn=14, base_vel=70, lead_ms=8.0),
    "Glinka":       dict(qpm=100, rubato=0.06, rit=0.35, art=0.94,
                         dyn=10, base_vel=63, lead_ms=14.0),
    "Balakirev":    dict(qpm=100, rubato=0.08, rit=0.40, art=0.96,
                         dyn=12, base_vel=65, lead_ms=16.0),
}

_TPB = 480            # output ticks per beat
_TEMPO_US = 500000    # fixed SMF tempo; expressiveness lives in the ticks
_PHRASE_BARS = 4
_GRID = Fraction(1, 8)  # tempo-integration step, in beats (32nd note)


def _merge_ties(score: XScore) -> List[Tuple[Fraction, Fraction, int, int]]:
    """(onset_beats, duration_beats, midi, part) with tied chains merged
    into one sounding note (beat = quarter note = whole/4)."""
    per_key: Dict[Tuple[int, int, int], List] = {}
    sounding = []
    for n in score.notes:
        if n.midi is None:
            continue
        per_key.setdefault((n.staff, n.voice, n.midi), []).append(n)
    for (part, _voice, midi), chain in per_key.items():
        chain.sort(key=lambda n: n.onset)
        open_note = None
        for n in chain:
            if open_note is not None and n.tie_stop and \
                    n.onset == open_note[0] + open_note[1]:
                open_note[1] += n.duration
                if not n.tie_start:
                    sounding.append(tuple(open_note))
                    open_note = None
                continue
            if open_note is not None:
                sounding.append(tuple(open_note))
                open_note = None
            if n.tie_start:
                open_note = [n.onset, n.duration, midi, part]
            else:
                sounding.append((n.onset, n.duration, midi, part))
        if open_note is not None:
            sounding.append(tuple(open_note))
    return [(Fraction(o) * 4, Fraction(d) * 4, m, p)
            for (o, d, m, p) in sounding]


class _TempoMap:
    """Integrated phrase-arch tempo: score beats -> performed seconds.

    Bar geometry comes from the true measure-start list (so meter changes
    mid-chunk keep the phrase arch, accents, and the final-ritardando
    window aligned with real barlines, not a nominal first-meter grid)."""

    def __init__(self, total_beats: float, barlines: List[float],
                 style: Dict[str, float]):
        self.spb = 60.0 / style["qpm"]
        self.total = max(total_beats, 1e-6)
        self.bars = sorted(set(barlines)) or [0.0]
        self.rubato = style["rubato"]
        self.rit = style["rit"]
        step = float(_GRID)
        # Cumulative performed time on a fine grid; onsets interpolate.
        self.grid_step = step
        self.cum = [0.0]
        t = 0.0
        b = 0.0
        while b < self.total + step:
            t += self._multiplier(b + step / 2) * step * self.spb
            self.cum.append(t)
            b += step

    def bar_index(self, b: float) -> int:
        import bisect
        return max(bisect.bisect_right(self.bars, b + 1e-9) - 1, 0)

    def _bar_frac(self, b: float) -> tuple:
        """(bar index, fractional position inside that bar)."""
        i = self.bar_index(b)
        start = self.bars[i]
        end = self.bars[i + 1] if i + 1 < len(self.bars) else self.total
        width = max(end - start, 1e-6)
        return i, min(max((b - start) / width, 0.0), 1.0)

    def _multiplier(self, b: float) -> float:
        """Local beat-duration multiplier at score beat b (>1 = slower)."""
        x = min(b / self.total, 1.0)             # piece position
        m = 1.0 + self.rubato * (2 * x - 1) ** 2  # global arch
        if len(self.bars) > _PHRASE_BARS:         # phrase arch (4-bar units)
            i, frac = self._bar_frac(b)
            xp = (i % _PHRASE_BARS + frac) / _PHRASE_BARS
            m *= 1.0 + 0.5 * self.rubato * (2 * xp - 1) ** 2
        last_bar = self.bars[-1]
        if b > last_bar and self.total > last_bar:  # final ritardando
            xr = (b - last_bar) / (self.total - last_bar)
            m *= 1.0 + self.rit * xr * xr
        return m

    def seconds(self, beats: float) -> float:
        pos = max(beats, 0.0) / self.grid_step
        i = int(pos)
        frac = pos - i
        if i + 1 >= len(self.cum):
            return self.cum[-1] + (pos - (len(self.cum) - 1)) \
                * self.grid_step * self.spb
        return self.cum[i] + frac * (self.cum[i + 1] - self.cum[i])


def _hash_unit(*key) -> float:
    """Deterministic pseudo-random in [-1, 1) from the note's identity."""
    h = hashlib.sha256(repr(key).encode()).digest()
    return int.from_bytes(h[:4], "big") / 2 ** 31 - 1.0


def render_performance(xml_path: str, composer: str = "DEFAULT",
                       out_path: Optional[str] = None) -> str:
    """Render a MusicXML score to an expressive performance MIDI file.

    Deterministic for a given (score, composer). Returns ``out_path``
    (default: a temp file next to nothing in particular — callers that
    feed MIDIProcess can pass their own staging path).
    """
    style = _STYLE.get(composer, _STYLE["DEFAULT"])
    score = parse_musicxml(xml_path)
    notes = _merge_ties(score)
    if not notes:
        raise RuntimeError(f"no notes in {xml_path}")

    # Bar geometry from part 0 (both staves share barlines in this
    # pipeline); beats are quarter notes. Per-measure time signatures are
    # respected, so meter changes mid-chunk keep accents/phrases aligned.
    barlines = [float(b) * 4 for b in (score.barlines[0]
                                       if score.barlines else [Fraction(0)])]
    tsigs = (score.times[0] if score.times and score.times[0]
             else [(4, 4)] * max(len(barlines), 1))
    total_beats = max(float(o + d) for (o, d, _m, _p) in notes)
    tempo = _TempoMap(total_beats, barlines, style)

    # Melody lead applies where both parts attack at the same score onset.
    onsets_by_part: Dict[int, set] = {}
    for (o, _d, _m, p) in notes:
        onsets_by_part.setdefault(p, set()).add(o)
    shared = (onsets_by_part.get(0, set())
              & set().union(*(s for pt, s in onsets_by_part.items()
                              if pt != 0)) if len(onsets_by_part) > 1
              else set())

    timed: List[Tuple[float, float, int, int]] = []  # (on_s, off_s, midi, vel)
    for idx, (onset, dur, midi, part) in enumerate(sorted(notes)):
        on_b, off_b = float(onset), float(onset + dur)
        on_s = tempo.seconds(on_b)
        off_s = tempo.seconds(off_b)
        # Articulation: scale the sounding time, keep at least 40 ms.
        sound = max((off_s - on_s) * style["art"], 0.04)
        # Velocity: arch + metrical accent + pitch height + micro-variance
        # (deadpan 'score' style: constant velocity, like score MIDI).
        vel = float(style["base_vel"])
        if not style.get("deadpan"):
            x = min(on_b / tempo.total, 1.0)
            vel += style["dyn"] * (1 - (2 * x - 1) ** 2)
            bar_idx = tempo.bar_index(on_b)
            bar_start = tempo.bars[bar_idx]
            m_tsig = tsigs[min(bar_idx, len(tsigs) - 1)]
            m_beats = 4.0 * m_tsig[0] / m_tsig[1]  # this bar's own meter
            beat_in_bar = on_b - bar_start
            if abs(beat_in_bar) < 1e-6:
                vel += 8                               # downbeat
            elif abs(beat_in_bar - m_beats / 2) < 1e-6 and m_beats >= 3:
                vel += 4                               # mid-bar strong beat
            vel += (midi - 60) * 0.15                  # pitch height
            vel += 2.0 * _hash_unit("vel", idx, midi)
        # Melody lead + deterministic micro-timing (never before t=0).
        if part == 0 and onset in shared:
            on_s -= style["lead_ms"] / 1000.0
        if on_b > 0 and not style.get("deadpan"):
            on_s += 0.004 * _hash_unit("t", idx, midi)
        on_s = max(on_s, 0.0)
        timed.append((on_s, on_s + sound, midi,
                      int(max(20, min(105, round(vel))))))

    # Emit one track of interleaved on/off events at the fixed tempo.
    spt = _TEMPO_US / 1e6 / _TPB
    events: List[Tuple[int, int, int, int]] = []  # (tick, order, status...)
    for (on_s, off_s, midi, vel) in timed:
        on_t = int(round(on_s / spt))
        off_t = max(int(round(off_s / spt)), on_t + 1)
        events.append((on_t, 1, 0x90, midi, vel))
        events.append((off_t, 0, 0x80, midi, 64))
    events.sort()

    track = [MidiEvent(0, 0xFF, b"\x51" + _TEMPO_US.to_bytes(3, "big")),
             MidiEvent(0, 0xC0, bytes([0]))]
    prev = 0
    for (tick, _order, status, midi, vel) in events:
        track.append(MidiEvent(tick - prev, status, bytes([midi, vel])))
        prev = tick
    midi_file = MidiFile(ticks_per_beat=_TPB, tracks=[track])

    if out_path is None:
        fd, out_path = tempfile.mkstemp(suffix=".mid", prefix="epr_native_")
        os.close(fd)
    write_midi_file(midi_file, out_path)
    return out_path


def make_native_epr_generator(out_dir: Optional[str] = None):
    """``epr_generate(xml_path, composer) -> midi_path`` using the native
    engine — drop-in for data.render.xml_to_midi's injection point. Each
    call overwrites one staging file (mirroring virtuosoNet's
    test_result/<v>_by_isgn_z0.mid single-slot contract). When no
    ``out_dir`` is given, a temp staging dir is created and removed at
    interpreter exit."""
    if out_dir is None:
        import atexit
        import shutil
        staging_dir = tempfile.mkdtemp(prefix="epr_native_")
        atexit.register(shutil.rmtree, staging_dir, ignore_errors=True)
    else:
        staging_dir = out_dir
    os.makedirs(staging_dir, exist_ok=True)
    slot = os.path.join(staging_dir, "epr_native_z0.mid")

    def epr_generate(xml_path: str, composer: str) -> str:
        return render_performance(xml_path, composer, out_path=slot)

    # xml_to_midi uses this to route composer=='score' chunks here (the
    # deadpan style) when verovio is absent; virtuosoNet adapters can't.
    epr_generate.handles_score = True
    return epr_generate
