"""Self-contained synthetic corpus generator.

A copy of piano_a2s_tpu/data/synth.py for the port: for the same seed it
writes the same files, byte for byte. Run it as
``python -m piano_a2s_tpu_torch.data.synth ROOT [--splits ...]``.

Produces full-size training corpora in the reference's on-disk feature
layout (reference: datasets/syn.py:28-58 contract, render.py's folder
structure) WITHOUT any external tool: additive-synthesis piano-like audio
is rendered directly from randomly drawn kern-token targets, and
spectrograms come from the librosa-algorithm oracle VQT
(ops/vqt_oracle.py) — the same frontend family the reference trains on.

The audio<->token mapping is deterministic, so a model can genuinely
LEARN (or overfit) it; uses:
  * smoke/e2e runs of the full-size training harness on the card
    without verovio/FluidSynth/soundfonts;
  * overfit experiments that need a sharp free-running decode (a model
    that emits EOS, so serving can exit early);
  * benchmarking Trainer.fit on realistic bar-length distributions.

Layout written per (split, version):
  {root}/{split}/{v}/spectrogram/{name}.npy   (<=1201, 480) f32 log-VQT
  {root}/{split}/{v}/target/{chunk}.pkl       [[key, ts, lower, upper]...]
  {root}/{split}/{v}/info/{chunk}.json        {"composer": "synth", ...}
  {root}/{split}/{v}/audio/{name}.npy         (optional) raw f32 @ 16 kHz
"""

from __future__ import annotations

import json
import os
import pickle
import re
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.vqt import VQTConfig, get_vqt_host
from ..symbolic.humdrum import kern_to_midi
from ..symbolic.vocab import LabelsMultiple

_UPPER_PITCHES = ["c", "d", "e", "f", "g", "a", "b",
                  "cc", "dd", "ee", "ff", "gg", "aa", "bb"]
_LOWER_PITCHES = ["C", "D", "E", "F", "G", "A", "B",
                  "CC", "DD", "EE", "FF", "GG", "AA", "BB"]
_DURATIONS = ["2", "4", "4", "8", "8", "16"]  # quarter/eighth-heavy mix
_NOTE_RE = re.compile(r"(\d+\.*)([a-gA-Gr]+[\-#]*)")


# Circle-of-fifths accidental orders: key signature +n sharps the first
# n letters of _SHARP_ORDER, -n flats the first n of _FLAT_ORDER.
_SHARP_ORDER = "fcgdaeb"
_FLAT_ORDER = "beadgcf"


def key_accidental(letter: str, key: int) -> str:
    """The accidental the key signature puts on this pitch letter."""
    low = letter[0].lower()
    if key > 0 and low in _SHARP_ORDER[:key]:
        return "#"
    if key < 0 and low in _FLAT_ORDER[:-key]:
        return "-"
    return ""


def random_bar_text(rng: np.random.RandomState, staff: str,
                    n_notes: Tuple[int, int], key: int = 0) -> str:
    """One bar of kern note text, pitch-random-walked within the staff's
    register (no chords/ties — plain learnable bars). Accidentals follow
    the KEY SIGNATURE (4% chromatic noise), so the rendered audio carries
    a learnable key signal — key_f1 is a real metric on this corpus."""
    pitches = _UPPER_PITCHES if staff == "upper" else _LOWER_PITCHES
    pos = rng.randint(len(pitches))
    notes = []
    for _ in range(rng.randint(n_notes[0], n_notes[1] + 1)):
        pos = int(np.clip(pos + rng.randint(-2, 3), 0, len(pitches) - 1))
        acc = key_accidental(pitches[pos], key)
        if rng.rand() < 0.04:  # chromatic passing tone
            acc = "-" if rng.rand() < 0.5 else "#"
        dur = _DURATIONS[rng.randint(len(_DURATIONS))]
        notes.append(f"{dur}{pitches[pos]}{acc}")
    return " ".join(notes)


def _note_fraction(dur_token: str) -> float:
    """Kern duration token -> whole-note fraction (dots extend by 1.5x)."""
    digits = dur_token.rstrip(".")
    frac = 1.0 / max(int(digits), 1)
    if dur_token.endswith("."):
        frac *= 1.5
    return frac


#: Rendering "timbre" — the per-version free parameters that stand in
#: for the reference's 10 EPR/soundfont renderings of the same score
#: (reference: render.py:235-272 maps each score over version folders).
#: Defaults reproduce the original single-version sound exactly.
DEFAULT_TIMBRE = {"detune_cents": 0.0, "decay": 0.35, "rolloff": 1.5,
                  "n_harmonics": 5, "attack": 0.005}


def version_timbre(rng: np.random.RandomState) -> dict:
    """Draw one rendering variant: detuning, decay, brightness, attack.
    Kept well inside the range where every note's fundamental still lands
    on its VQT bin (detune <=12 cents vs the 20-cent bin spacing), so the
    audio->token mapping stays learnable across versions."""
    return {"detune_cents": float(rng.uniform(-8.0, 8.0)),
            "decay": float(rng.uniform(0.22, 0.55)),
            "rolloff": float(rng.uniform(1.15, 2.0)),
            "n_harmonics": int(rng.randint(4, 8)),
            "attack": float(rng.uniform(0.003, 0.012))}


def synthesize_bar(bar_text: str, bar_seconds: float, sr: int,
                   out: np.ndarray, offset_s: float,
                   timbre: Optional[dict] = None) -> None:
    """Additively render one staff's bar into `out` (in place): damped
    harmonics per note, notes laid out sequentially and scaled to fill
    the bar. `timbre` varies the rendering (see DEFAULT_TIMBRE)."""
    tb = {**DEFAULT_TIMBRE, **(timbre or {})}
    notes = _NOTE_RE.findall(bar_text)
    if not notes:
        return
    fracs = [_note_fraction(d) for d, _ in notes]
    scale = bar_seconds / sum(fracs)
    t0 = offset_s
    detune = 2.0 ** (tb["detune_cents"] / 1200.0)
    for (dur, pitch), frac in zip(notes, fracs):
        seconds = frac * scale
        if pitch != "r":
            midi = kern_to_midi(pitch)
            f0 = 440.0 * 2.0 ** ((midi - 69) / 12.0) * detune
            n = int(seconds * sr)
            start = int(t0 * sr)
            n = min(n, len(out) - start)
            if n > 0:
                t = np.arange(n) / sr
                env = (np.exp(-t / tb["decay"])
                       * np.minimum(t / tb["attack"], 1.0))
                tone = np.zeros(n)
                for h in range(1, tb["n_harmonics"] + 1):
                    fh = f0 * h
                    if fh < sr / 2:
                        tone += np.sin(2 * np.pi * fh * t) / h ** tb["rolloff"]
                out[start:start + n] += 0.2 * env * tone
        t0 += seconds


def synthesize_target_audio(target: List[list], sr: int = 16000,
                            clip_seconds: float = 11.8,
                            bar_texts: Optional[List[Tuple[str, str]]]
                            = None,
                            timbre: Optional[dict] = None) -> np.ndarray:
    """Render a target structure's bars to mono audio. `bar_texts` gives
    (upper_text, lower_text) per bar; without it the token ids are decoded
    back to text first (the mapping is the decode of the target).
    `timbre` selects a rendering variant (multi-version corpora render the
    SAME target several ways, like the reference's EPR/soundfont
    versions)."""
    labels = LabelsMultiple(extended=True)
    n_bars = len(target)
    bar_seconds = clip_seconds / n_bars
    out = np.zeros(int(clip_seconds * sr) + sr // 10, np.float64)
    for i, measure in enumerate(target):
        if bar_texts is not None:
            up_text, low_text = bar_texts[i]
        else:
            up_text = "".join(labels.decode(measure[3]))
            low_text = "".join(labels.decode(measure[2]))
        synthesize_bar(up_text, bar_seconds, sr, out, i * bar_seconds,
                       timbre)
        synthesize_bar(low_text, bar_seconds, sr, out, i * bar_seconds,
                       timbre)
    peak = np.abs(out).max()
    if peak > 0:
        out *= 0.7 / peak
    return out.astype(np.float32)


def draw_song(rng: np.random.RandomState, n_bars: int = 5,
              upper_notes=(4, 9), lower_notes=(3, 6)):
    """Draw one song's symbolic content only: (target, bar_texts).
    Rendering is separate so multi-version corpora can render the SAME
    target several ways (make_song = draw_song + one default render)."""
    labels = LabelsMultiple(extended=True)
    key = int(rng.randint(-6, 8))
    ts = "4/4"
    target, texts = [], []
    for _ in range(n_bars):
        up = random_bar_text(rng, "upper", upper_notes, key=key)
        low = random_bar_text(rng, "lower", lower_notes, key=key)
        target.append([key, ts, labels.encode(low), labels.encode(up)])
        texts.append((up, low))
    return target, texts


def make_song(rng: np.random.RandomState, n_bars: int = 5,
              upper_notes=(4, 9), lower_notes=(3, 6)):
    """-> (target, audio): one song's target structure + rendered clip.

    All four prediction heads carry signal in the audio: tokens and
    durations directly, and the key signature through the key-consistent
    accidentals random_bar_text applies (before round 3 the key label
    was independent of the pitches, making key_f1 chance-level ~1/14 by
    construction on synth runs). Caveat: the ENHARMONIC pairs +6/-6
    (F#/Gb) and +7/-5 (C#/Db) render identical pitch-class audio, so
    key_f1 saturates near ~0.86 — the measured 0.875 (DESIGN §10) is AT
    this corpus ceiling, not below a reachable 1.0."""
    target, texts = draw_song(rng, n_bars, upper_notes, lower_notes)
    audio = synthesize_target_audio(target, bar_texts=texts)
    return target, audio


# ---------------------------------------------------------------------------
# Chordal generator — the real pipeline's target shape.
#
# The reference's pretrain corpus is CHORDAL kern with ties, rests and a
# 7-meter mix (reference: data_processing/render.py:204-230 builds targets
# from real MuseSyn/HumSyn scores; chord encoding via '<b>' and event
# separation via '\n' at data_processing/humdrum.py:99-127). The legacy
# generator above emits one note per '<b>'-joined token group — chord-free
# streams the GA token map handles but the real workload never looks like.
# Everything below draws songs with the real semantics: simultaneous EVENTS
# separated by the newline token, chord notes space-joined (-> '<b>'), each
# chord note carrying its own duration, cross-bar ties '[' ... ']', rests,
# and a per-song meter from the reference's 7-entry table
# (data_processing/metadata/time_signature_list.json).
# ---------------------------------------------------------------------------

#: (time-signature string, bar length in whole notes).
_METERS: List[Tuple[str, Fraction]] = [
    ("4/4", Fraction(1, 1)), ("3/4", Fraction(3, 4)),
    ("2/4", Fraction(1, 2)), ("6/8", Fraction(3, 4)),
    ("2/2", Fraction(1, 1)), ("12/8", Fraction(3, 2)),
    ("3/8", Fraction(3, 8)),
]

#: Duration pools: (kern token, whole-note fraction, draw weight).
#: Simple meters favor quarters/eighths; compound meters favor the
#: dotted-quarter beat. Every bar length is a multiple of 1/16, and 1/16
#: is in both pools, so greedy exact tiling always terminates.
_SIMPLE_DURS = [("2", Fraction(1, 2), 1), ("4", Fraction(1, 4), 4),
                ("4.", Fraction(3, 8), 1), ("8", Fraction(1, 8), 4),
                ("8.", Fraction(3, 16), 1), ("16", Fraction(1, 16), 2)]
_COMPOUND_DURS = [("4.", Fraction(3, 8), 3), ("8", Fraction(1, 8), 4),
                  ("8.", Fraction(3, 16), 1), ("16", Fraction(1, 16), 2)]


class _Event:
    """One simultaneous event on one staff: a rest, a note, or a chord.

    notes: [(pitch_text, accidental)] sorted ascending by pitch (the
    reference sorts chord notes by MIDI pitch, humdrum.py sort_chords);
    empty for rests. tie_open marks the LAST event of a bar whose sound
    continues into the next bar's FIRST event (tie_close)."""

    __slots__ = ("dur_tok", "frac", "notes", "tie_open", "tie_close")

    def __init__(self, dur_tok: str, frac: Fraction, notes,
                 tie_open: bool = False, tie_close: bool = False):
        self.dur_tok, self.frac, self.notes = dur_tok, frac, list(notes)
        self.tie_open, self.tie_close = tie_open, tie_close

    @property
    def is_rest(self) -> bool:
        return not self.notes

    def text(self) -> str:
        if self.is_rest:
            return f"{self.dur_tok}r"
        op = "[" if self.tie_open else ""
        cl = "]" if self.tie_close else ""
        return " ".join(f"{op}{self.dur_tok}{p}{a}{cl}"
                        for p, a in self.notes)


def _draw_bar_events(rng: np.random.RandomState, bar_len: Fraction,
                     staff: str, key: int, pos: int,
                     chord_p: float, rest_p: float) -> Tuple[list, int]:
    """Greedy exact tiling of one bar with events; returns (events, pos).

    The pitch register random-walks like the legacy generator; chords are
    stacked thirds from the walk position (2-3 notes upper, 2 lower —
    keeping the lower staff inside its 189-token/bar cap even for 12/8)."""
    pitches = _UPPER_PITCHES if staff == "upper" else _LOWER_PITCHES
    pool = _COMPOUND_DURS if bar_len.denominator >= 8 else _SIMPLE_DURS
    # The lower staff favors longer values (min 1/8) so its token count
    # stays well under max_length[1]=189 even in 12/8.
    min_frac = Fraction(1, 8) if staff == "lower" else Fraction(1, 16)
    events: List[_Event] = []
    remaining = bar_len
    while remaining > 0:
        fits = [(t, f) for t, f, w in pool if f <= remaining
                for _ in range(w)]
        pref = [(t, f) for t, f in fits if f >= min_frac]
        dur_tok, frac = (pref or fits)[rng.randint(len(pref or fits))]
        if rng.rand() < rest_p:
            events.append(_Event(dur_tok, frac, []))
        else:
            pos = int(np.clip(pos + rng.randint(-2, 3), 0,
                              len(pitches) - 1))
            n_notes = 1
            if rng.rand() < chord_p:
                n_notes = (2 + (rng.rand() < 0.4)
                           if staff == "upper" else 2)
            idxs = sorted({int(np.clip(pos + 2 * k, 0, len(pitches) - 1))
                           for k in range(n_notes)})
            notes = []
            for i in idxs:
                acc = key_accidental(pitches[i], key)
                if rng.rand() < 0.04:  # chromatic passing tone
                    acc = "-" if rng.rand() < 0.5 else "#"
                notes.append((pitches[i], acc))
            events.append(_Event(dur_tok, frac, notes))
        remaining -= frac
    return events, pos


def draw_song_chordal(rng: np.random.RandomState, n_bars: int = 5,
                      chord_p: float = 0.35, rest_p: float = 0.08,
                      tie_p: float = 0.25):
    """Draw one chordal song: (target, bars) with real-pipeline semantics.

    target: the reference per-measure structure [[key, ts, lower, upper]];
    bars: per-bar (upper_events, lower_events) lists for the renderer.
    One meter per song from the 7-entry table; cross-bar ties connect a
    bar's last single-note event to the next bar's first event when both
    are single non-rest notes (the tie-close copies the pitch, keeping
    its own duration — exactly kern's '[2c ... 2c]' shape)."""
    labels = LabelsMultiple(extended=True)
    key = int(rng.randint(-6, 8))
    ts, bar_len = _METERS[rng.randint(len(_METERS))]
    pos_up = rng.randint(len(_UPPER_PITCHES))
    pos_low = rng.randint(len(_LOWER_PITCHES))
    bars = []
    for _ in range(n_bars):
        up, pos_up = _draw_bar_events(rng, bar_len, "upper", key, pos_up,
                                      chord_p, rest_p)
        low, pos_low = _draw_bar_events(rng, bar_len, "lower", key,
                                        pos_low, 0.6 * chord_p, rest_p)
        bars.append((up, low))
    # Cross-bar ties (decided after generation so both sides exist).
    for b in range(n_bars - 1):
        for s in range(2):
            last, first = bars[b][s][-1], bars[b + 1][s][0]
            if (len(last.notes) == 1 and len(first.notes) == 1
                    and rng.rand() < tie_p):
                first.notes = list(last.notes)  # same pitch sustains
                last.tie_open, first.tie_close = True, True
    target = []
    for up, low in bars:
        up_text = "\n".join(e.text() for e in up)
        low_text = "\n".join(e.text() for e in low)
        target.append([key, ts, labels.encode(low_text),
                       labels.encode(up_text)])
    return target, bars


def _render_note(out: np.ndarray, start_s: float, dur_s: float,
                 midi: int, sr: int, tb: dict, gain: float) -> None:
    """Render one damped-harmonic note into `out` in place."""
    detune = 2.0 ** (tb["detune_cents"] / 1200.0)
    f0 = 440.0 * 2.0 ** ((midi - 69) / 12.0) * detune
    start = int(start_s * sr)
    n = min(int(dur_s * sr), len(out) - start)
    if n <= 0:
        return
    t = np.arange(n) / sr
    env = np.exp(-t / tb["decay"]) * np.minimum(t / tb["attack"], 1.0)
    tone = np.zeros(n)
    for h in range(1, tb["n_harmonics"] + 1):
        fh = f0 * h
        if fh < sr / 2:
            tone += np.sin(2 * np.pi * fh * t) / h ** tb["rolloff"]
    out[start:start + n] += gain * env * tone


def synthesize_chordal_audio(bars, sr: int = 16000,
                             clip_seconds: float = 11.8,
                             timbre: Optional[dict] = None) -> np.ndarray:
    """Render a chordal song (draw_song_chordal's `bars`) to mono audio.

    Events lay out sequentially within each equal-length bar, scaled so
    the bar's duration fractions exactly fill it — the same proportional-
    to-duration layout the guided-attention event map assumes. Tied pairs
    render as ONE continuous note spanning the barline (no re-attack), so
    the tie token carries a real acoustic signal the model can learn."""
    tb = {**DEFAULT_TIMBRE, **(timbre or {})}
    n_bars = len(bars)
    bar_seconds = clip_seconds / n_bars
    out = np.zeros(int(clip_seconds * sr) + sr // 10, np.float64)
    for staff in range(2):
        pending = {}  # midi -> (start_s, dur_s) of an open tie
        for b, bar in enumerate(bars):
            events = bar[staff]
            bar_len = sum(e.frac for e in events)
            scale = bar_seconds / float(bar_len)
            t0 = b * bar_seconds
            for e in events:
                dur_s = float(e.frac) * scale
                opened = {}
                for p, a in e.notes:
                    midi = kern_to_midi(p + a)
                    if e.tie_close and midi in pending:
                        s0, d0 = pending.pop(midi)
                        _render_note(out, s0, d0 + dur_s, midi, sr, tb,
                                     0.2)
                    elif e.tie_open:
                        opened[midi] = (t0, dur_s)
                    else:
                        _render_note(out, t0, dur_s, midi, sr, tb, 0.2)
                # A tie can only close on the event IMMEDIATELY after its
                # open (bar-k last -> bar-k+1 first); anything still
                # pending was never closed and must sound now.
                for midi, (s0, d0) in pending.items():
                    _render_note(out, s0, d0, midi, sr, tb, 0.2)
                pending = opened
                t0 += dur_s
        for midi, (s0, d0) in pending.items():
            _render_note(out, s0, d0, midi, sr, tb, 0.2)
    peak = np.abs(out).max()
    if peak > 0:
        out *= 0.7 / peak
    return out.astype(np.float32)


#: Pseudo-soundfont names per version index (the ~{font} name suffix the
#: datasets/summaries parse; reference: render.py:274-319's soundfonts).
_VERSION_FONTS = ["Upright", "Salamander", "YDP", "Grand", "Bright"]


def write_corpus(feature_folder: str, split: str, n_songs: int,
                 version: int = 0, seed: int = 0, n_bars: int = 5,
                 sr: int = 16000, max_frame_num: int = 1201,
                 save_audio: bool = True, frontend: str = "oracle",
                 versions: Optional[Sequence[int]] = None,
                 style_mix: bool = False, chordal: bool = False) -> int:
    """Generate one split's feature folders; returns #songs written.

    frontend='oracle' uses the librosa-algorithm multirate VQT (what the
    reference's pipeline would produce; ops/vqt_oracle.py); 'direct' uses
    ops/vqt.py's full-rate host twin (get_vqt_host); 'none' skips
    spectrograms entirely (audio-input training — `input_features:
    audio` — reads only audio/, and the host oracle VQT dominates
    generation time for large corpora).

    `versions` renders EVERY song once per version: identical targets,
    different timbre/tempo per version (version_timbre) — the synth
    counterpart of the reference's 10 renderings per score that
    SyntheticTrainDataset's random-version sampling expects
    (reference: render.py:235-272, syn.py:88-121). `style_mix`
    capitalizes half the chunk names so both result styles ("pop" /
    "classical", harness style = chunk[0].islower()) appear.

    `chordal` switches to the real-pipeline target shape: newline-separated
    events, '<b>'-joined chords, cross-bar ties, rests, and the 7-meter mix
    (draw_song_chordal) — the reference's actual workload structure."""
    cfg = VQTConfig(sample_rate=sr)
    if frontend == "none" and not save_audio:
        raise ValueError("frontend='none' with save_audio=False would "
                         "write no features at all")
    if frontend == "oracle":
        # scipy's multirate oracle is loaded only when it is asked for.
        from ..ops.vqt_oracle import get_vqt_librosa_host as vqt
    else:
        vqt = {"direct": get_vqt_host, "none": None}[frontend]
    subs = ["target", "info"] + (["spectrogram"] if vqt else []) \
        + (["audio"] if save_audio else [])

    if versions is None:
        # Single-version path: byte-identical to the pre-multi-version
        # generator (one sequential RNG stream drives draw + render).
        rng = np.random.RandomState(seed)
        base = os.path.join(feature_folder, split, str(version))
        for sub in subs:
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for s in range(n_songs):
            chunk = f"syn{seed}_{s:03d}"
            name = f"{chunk}~v0~Upright"
            if chordal:
                target, bars = draw_song_chordal(rng, n_bars=n_bars)
                audio = synthesize_chordal_audio(bars, sr=sr)
            else:
                target, audio = make_song(rng, n_bars=n_bars)
            _write_song(base, chunk, name, target, audio, vqt, cfg,
                        max_frame_num, save_audio, n_bars)
        return n_songs

    bases = {}
    for v in versions:
        base = os.path.join(feature_folder, split, str(v))
        for sub in subs:
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        bases[v] = base
    for s in range(n_songs):
        # Per-song RNG: the target is a function of (seed, s) alone, so
        # every version carries the SAME symbolic content.
        song_rng = np.random.RandomState((seed * 100003 + s) % (2 ** 31))
        if chordal:
            target, bars = draw_song_chordal(song_rng, n_bars=n_bars)
        else:
            target, texts = draw_song(song_rng, n_bars=n_bars)
        chunk = f"syn{seed}_{s:03d}"
        if style_mix and s % 2:
            chunk = chunk.capitalize()  # "Syn..." -> pop style
        for v in versions:
            tim_rng = np.random.RandomState(
                ((seed * 100003 + s) * 31 + 7 * v + 1) % (2 ** 31))
            timbre = version_timbre(tim_rng)
            clip_seconds = float(tim_rng.uniform(10.2, 11.8))
            if chordal:
                audio = synthesize_chordal_audio(
                    bars, sr=sr, clip_seconds=clip_seconds, timbre=timbre)
            else:
                audio = synthesize_target_audio(
                    target, sr=sr, clip_seconds=clip_seconds,
                    bar_texts=texts, timbre=timbre)
            font = _VERSION_FONTS[v % len(_VERSION_FONTS)]
            name = f"{chunk}~v{v}~{font}"
            _write_song(bases[v], chunk, name, target, audio, vqt, cfg,
                        max_frame_num, save_audio, n_bars)
    return n_songs


def _write_song(base, chunk, name, target, audio, vqt, cfg,
                max_frame_num, save_audio, n_bars):
    if vqt:
        spec = np.asarray(vqt(audio, cfg), np.float32)[:max_frame_num]
        np.save(os.path.join(base, "spectrogram", f"{name}.npy"), spec)
    with open(os.path.join(base, "target", f"{chunk}.pkl"), "wb") as f:
        pickle.dump(target, f)
    with open(os.path.join(base, "info", f"{chunk}.json"), "w") as f:
        json.dump({"composer": "synth", "n_bars": n_bars}, f)
    if save_audio:
        np.save(os.path.join(base, "audio", f"{name}.npy"), audio)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("root", help="feature folder to create")
    ap.add_argument("--splits", default="train:32,valid:8,test:8",
                    help="comma list of split:n_songs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bars", type=int, default=5)
    ap.add_argument("--no-audio", action="store_true")
    ap.add_argument("--frontend", default="oracle",
                    choices=["oracle", "direct", "none"],
                    help="spectrogram source; 'none' writes audio/targets "
                         "only (enough for input_features: audio training "
                         "and ~10x faster to generate)")
    ap.add_argument("--train-versions", type=int, default=1,
                    help="render each TRAIN song this many times with "
                         "distinct timbre/tempo (versions 0..N-1); valid/"
                         "test stay single-version like the reference's "
                         "score-MIDI splits")
    ap.add_argument("--style-mix", action="store_true",
                    help="capitalize half the chunk names so both result "
                         "styles (pop/classical) appear")
    ap.add_argument("--chordal", action="store_true",
                    help="real-pipeline target shape: newline-separated "
                         "events, '<b>'-joined chords, cross-bar ties, "
                         "rests, 7-meter mix (the reference's actual "
                         "workload structure)")
    args = ap.parse_args(argv)
    for i, part in enumerate(args.splits.split(",")):
        split, n = part.split(":")
        versions = (list(range(args.train_versions))
                    if split == "train" and args.train_versions > 1
                    else None)
        # Distinct seed per split — the same seed would draw IDENTICAL
        # songs for train/valid/test (no held-out data at all).
        n = write_corpus(args.root, split, int(n),
                         seed=args.seed + 7919 * (i + 1),
                         n_bars=args.bars, save_audio=not args.no_audio,
                         frontend=args.frontend, versions=versions,
                         style_mix=args.style_mix, chordal=args.chordal)
        print(f"{split}: {n} songs" + (
            f" x {args.train_versions} versions" if versions else ""))


if __name__ == "__main__":
    main()
