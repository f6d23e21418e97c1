"""Native MV2H scorer: Multi-pitch / Voice / Meter / Value / Harmony.

A copy of piano_a2s_tpu/train/mv2h.py for the port: the same scores,
float for float, on the same files.

Implements the MV2H transcription metric of McLeod & Steedman,
"Evaluating Automatic Polyphonic Music Transcription" (ISMIR 2018) —
the reference's north-star benchmark (reference: evaluate.py:40-60,
evaluate_midi_mv2h.sh:8-10) — without the external Java tool:

  * ``midi_to_score`` is the ``mv2h.tools.Converter`` twin: SMF ->
    notes / metrical tatum grid / hierarchy / keys, emitted in (and
    parsed from) the tool's intermediate text format, so native and
    Java pipelines interoperate file-for-file.
  * ``evaluate_mv2h`` is the ``mv2h.Main -g ref -t hyp -a`` twin: DTW
    onset alignment followed by the five component scores and their
    mean.

The Java tool remains CANONICAL: the offline evaluator
(train/evaluate_offline.py) invokes it whenever ``java`` + the MV2H
classpath are available and only falls back to this module otherwise.
Semantics follow the published algorithm; where the paper leaves a
choice open, the behavior is documented inline and pinned by the JAX
package's tests (tests/test_mv2h_native.py), which the port's copy is held
to. Times are integer milliseconds throughout,
like the tool's format.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# The tool's matching tolerance: note onsets and metrical-grouping
# endpoints match within 50 ms.
ONSET_TOL_MS = 50


# ---------------------------------------------------------------------------
# Score representation (the intermediate text format's content)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Note:
    pitch: int      # MIDI pitch
    on: int         # performed onset (ms)
    val_on: int     # notated-value onset (ms); == on for MIDI input
    val_off: int    # notated-value offset (ms)
    voice: int

    @property
    def dur(self) -> int:
        return self.val_off - self.val_on


@dataclasses.dataclass
class Hierarchy:
    beats_per_bar: int = 4
    sub_beats_per_beat: int = 2
    tatums_per_sub_beat: int = 1
    anacrusis: int = 0          # length in tatums before the first full bar


@dataclasses.dataclass
class MV2HScore:
    notes: List[Note] = dataclasses.field(default_factory=list)
    tatums: List[int] = dataclasses.field(default_factory=list)
    hierarchy: Hierarchy = dataclasses.field(default_factory=Hierarchy)
    keys: List[Tuple[int, bool, int]] = dataclasses.field(
        default_factory=list)     # (tonic pitch class, is_major, time ms)
    chords: List[Tuple[int, str]] = dataclasses.field(
        default_factory=list)     # (time ms, symbol)

    def to_text(self) -> str:
        """The tool's intermediate format (Converter stdout)."""
        lines = []
        for n in sorted(self.notes, key=lambda n: (n.on, n.pitch, n.voice)):
            lines.append(f"Note {n.pitch} {n.on} {n.val_on} {n.val_off} "
                         f"{n.voice}")
        for t in self.tatums:
            lines.append(f"Tatum {t}")
        h = self.hierarchy
        lines.append(f"Hierarchy {h.beats_per_bar},{h.sub_beats_per_beat} "
                     f"{h.tatums_per_sub_beat} a={h.anacrusis}")
        for tonic, major, time in self.keys:
            lines.append(f"Key {tonic} {'Maj' if major else 'Min'} {time}")
        for time, symbol in self.chords:
            lines.append(f"Chord {time} {symbol}")
        return "\n".join(lines) + "\n"

    def end_time(self) -> int:
        ends = [n.val_off for n in self.notes] + list(self.tatums[-1:])
        return max(ends) if ends else 0


def parse_score(text: str) -> MV2HScore:
    """Parse the intermediate text format (Converter output — ours or the
    Java tool's). Unknown line kinds are ignored so real Converter stdout
    with extra diagnostics still parses."""
    score = MV2HScore()
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        kind = parts[0]
        if kind == "Note" and len(parts) >= 6:
            score.notes.append(Note(int(parts[1]), int(parts[2]),
                                    int(parts[3]), int(parts[4]),
                                    int(parts[5])))
        elif kind == "Tatum" and len(parts) >= 2:
            score.tatums.append(int(parts[1]))
        elif kind == "Hierarchy" and len(parts) >= 3:
            bpb, sbpb = (int(x) for x in parts[1].split(","))
            h = Hierarchy(bpb, sbpb, int(parts[2]))
            # First anacrusis token wins ("a=N" and a trailing
            # "anacrusis=N" alias may both appear; they are one field).
            for tok in parts[3:]:
                if tok.startswith(("a=", "anacrusis=")):
                    h.anacrusis = int(tok.split("=", 1)[1])
                    break
            score.hierarchy = h
        elif kind == "Key" and len(parts) >= 3:
            time = int(parts[3]) if len(parts) > 3 else 0
            score.keys.append((int(parts[1]),
                               parts[2].lower().startswith("maj"), time))
        elif kind == "Chord" and len(parts) >= 3:
            score.chords.append((int(parts[1]), parts[2]))
    score.tatums.sort()
    score.keys.sort(key=lambda k: k[2])
    score.chords.sort(key=lambda c: c[0])
    return score


# ---------------------------------------------------------------------------
# MIDI -> score: the mv2h.tools.Converter twin
# ---------------------------------------------------------------------------

def midi_to_score(path: str) -> MV2HScore:
    """Convert an SMF to the MV2H representation.

    Mirrors what the Java Converter extracts from MIDI: one voice per
    track that contains notes; a tatum grid at the sub-beat level from
    the tempo map + time signatures (compound meters — numerator a
    multiple of 3 above 3 — group as num/3 beats of 3 sub-beats,
    simple meters as num beats of 2 sub-beats); keys from key-signature
    metas via the circle of fifths. Our exported MIDIs
    (symbolic/midi.py: fixed 120 BPM, signatures at time 0) exercise
    the single-segment case; the tempo/signature maps are general.
    """
    from ..symbolic.midi_io import read_midi
    midi = read_midi(path)
    tpq = midi.ticks_per_beat

    # Absolute-tick event streams.
    tempos: List[Tuple[int, int]] = []          # (tick, us_per_quarter)
    time_sigs: List[Tuple[int, int, int]] = []  # (tick, num, den)
    key_sigs: List[Tuple[int, int, int]] = []   # (tick, sf, mi)
    note_tracks: List[List[Tuple[int, int, int]]] = []  # (on, off, pitch)
    for track in midi.tracks:
        t = 0
        active: Dict[int, List[int]] = {}
        notes: List[Tuple[int, int, int]] = []
        for ev in track:
            t += ev.delta
            if ev.status == 0xFF:
                meta, payload = ev.data[:1], ev.data[1:]
                if meta == b"\x51" and len(payload) >= 3:
                    tempos.append((t, int.from_bytes(payload[:3], "big")))
                elif meta == b"\x58" and len(payload) >= 2:
                    time_sigs.append((t, payload[0], 1 << payload[1]))
                elif meta == b"\x59" and len(payload) >= 2:
                    sf = payload[0] - 256 if payload[0] > 127 else payload[0]
                    key_sigs.append((t, sf, payload[1]))
            elif ev.kind == "note_on" and len(ev.data) >= 2 \
                    and ev.data[1] > 0:
                active.setdefault(ev.data[0], []).append(t)
            elif ev.kind in ("note_off", "note_on") and len(ev.data) >= 2:
                starts = active.get(ev.data[0])
                if starts:
                    notes.append((starts.pop(0), t, ev.data[0]))
        if notes:
            note_tracks.append(sorted(notes))
    tempos.sort()
    time_sigs.sort()
    key_sigs.sort()

    # Piecewise-linear tick -> ms map from the tempo segments.
    if not tempos or tempos[0][0] > 0:
        tempos.insert(0, (0, 500000))
    anchors_ms = [0.0]
    for i in range(1, len(tempos)):
        dt = tempos[i][0] - tempos[i - 1][0]
        anchors_ms.append(anchors_ms[-1]
                          + dt * tempos[i - 1][1] / 1000.0 / tpq)

    def tick_ms(tick: int) -> int:
        i = 0
        for j, (seg_tick, _) in enumerate(tempos):
            if seg_tick <= tick:
                i = j
        return round(anchors_ms[i]
                     + (tick - tempos[i][0]) * tempos[i][1] / 1000.0 / tpq)

    score = MV2HScore()
    for voice, notes in enumerate(note_tracks):
        for on, off, pitch in notes:
            on_ms, off_ms = tick_ms(on), tick_ms(off)
            score.notes.append(Note(pitch, on_ms, on_ms, off_ms, voice))

    # Tatum grid at the sub-beat level (tatums_per_sub_beat = 1), from
    # time 0 through the last note offset.
    if not time_sigs or time_sigs[0][0] > 0:
        time_sigs.insert(0, (0, 4, 4))
    last_tick = max((off for notes in note_tracks for _, off, _ in notes),
                    default=0)
    first_num, first_den = time_sigs[0][1], time_sigs[0][2]
    score.hierarchy = _hierarchy_for(first_num, first_den)
    for i, (seg_tick, num, den) in enumerate(time_sigs):
        seg_end = (time_sigs[i + 1][0] if i + 1 < len(time_sigs)
                   else last_tick)
        sub_beat = _sub_beat_ticks(num, den, tpq)
        # Each segment's grid re-anchors at ITS signature-change tick:
        # carrying the previous segment's sub-beat overshoot forward
        # would phase-shift every tatum after a denominator/compound
        # change (e.g. 4/4 -> 2/2 at tick 1920 mis-gridded 2160, 2640...
        # instead of 1920, 2400... — 250 ms off at 120 BPM, beyond
        # ONSET_TOL_MS, collapsing the Meter score for the whole tail).
        tick = float(seg_tick)
        while tick <= seg_end:
            score.tatums.append(tick_ms(round(tick)))
            tick += sub_beat
    score.tatums = sorted(set(score.tatums))

    for tick, sf, mi in key_sigs:
        tonic = (7 * sf + (0 if mi == 0 else 9)) % 12
        score.keys.append((tonic, mi == 0, tick_ms(tick)))
    return score


def _hierarchy_for(num: int, den: int) -> Hierarchy:
    if num > 3 and num % 3 == 0:     # compound meter: 6/8, 9/8, 12/8...
        return Hierarchy(num // 3, 3, 1)
    return Hierarchy(num, 2, 1)


def _sub_beat_ticks(num: int, den: int, tpq: int) -> float:
    unit = tpq * 4.0 / den           # one denominator unit in ticks
    if num > 3 and num % 3 == 0:
        return unit                  # compound: sub-beat = the unit itself
    return unit / 2.0                # simple: sub-beat = half a beat


# ---------------------------------------------------------------------------
# DTW onset alignment (the -a flag)
# ---------------------------------------------------------------------------

def align_gt_times(gt: MV2HScore, tr: MV2HScore):
    """Monotone map from ground-truth time onto the transcription's time
    axis, built by DTW over note-onset clusters with a pitch-set-overlap
    cost (the tool's -a behavior: scores are computed after aligning the
    ground truth to the transcription). Identity when either side has no
    notes. Piecewise linear between matched onsets, constant-offset
    extrapolation outside them."""
    g_on = _onset_clusters(gt)
    t_on = _onset_clusters(tr)
    if not g_on or not t_on:
        return lambda x: x
    ng, nt = len(g_on), len(t_on)
    INF = float("inf")
    D = [[INF] * (nt + 1) for _ in range(ng + 1)]
    D[0][0] = 0.0
    move = [[0] * (nt + 1) for _ in range(ng + 1)]  # 1=diag 2=up 3=left
    for i in range(1, ng + 1):
        for j in range(1, nt + 1):
            c = 1.0 - _pitch_f1(g_on[i - 1][1], t_on[j - 1][1])
            best, m = D[i - 1][j - 1], 1
            if D[i - 1][j] < best:
                best, m = D[i - 1][j], 2
            if D[i][j - 1] < best:
                best, m = D[i][j - 1], 3
            D[i][j] = best + c
            move[i][j] = m
        D[i][0] = INF
    for j in range(1, nt + 1):
        D[0][j] = INF
    D[0][0] = 0.0
    # Backtrack, keeping diagonal steps with pitch overlap as anchors.
    anchors: List[Tuple[int, int]] = []
    i, j = ng, nt
    while i > 0 and j > 0:
        m = move[i][j]
        if m == 1:
            if _pitch_f1(g_on[i - 1][1], t_on[j - 1][1]) > 0:
                anchors.append((g_on[i - 1][0], t_on[j - 1][0]))
            i, j = i - 1, j - 1
        elif m == 2:
            i -= 1
        else:
            j -= 1
    anchors.reverse()
    if not anchors:
        return lambda x: x

    def convert(x):
        if x <= anchors[0][0]:
            return x + (anchors[0][1] - anchors[0][0])
        if x >= anchors[-1][0]:
            return x + (anchors[-1][1] - anchors[-1][0])
        for k in range(1, len(anchors)):
            g0, t0 = anchors[k - 1]
            g1, t1 = anchors[k]
            if x <= g1:
                if g1 == g0:
                    return t1
                return round(t0 + (x - g0) * (t1 - t0) / (g1 - g0))
        return x
    return convert


def _onset_clusters(score: MV2HScore):
    by_onset: Dict[int, List[int]] = {}
    for n in score.notes:
        by_onset.setdefault(n.on, []).append(n.pitch)
    return sorted(by_onset.items())


def _pitch_f1(a: Sequence[int], b: Sequence[int]) -> float:
    sa, sb = sorted(a), sorted(b)
    i = j = tp = 0
    while i < len(sa) and j < len(sb):
        if sa[i] == sb[j]:
            tp += 1
            i += 1
            j += 1
        elif sa[i] < sb[j]:
            i += 1
        else:
            j += 1
    return 2.0 * tp / (len(sa) + len(sb)) if (sa or sb) else 1.0


def _apply_time_map(score: MV2HScore, convert) -> MV2HScore:
    return MV2HScore(
        notes=[Note(n.pitch, convert(n.on), convert(n.val_on),
                    convert(n.val_off), n.voice) for n in score.notes],
        tatums=[convert(t) for t in score.tatums],
        hierarchy=score.hierarchy,
        keys=[(t, m, convert(time)) for t, m, time in score.keys],
        chords=[(convert(time), s) for time, s in score.chords])


# ---------------------------------------------------------------------------
# Component metrics
# ---------------------------------------------------------------------------

def _f1(tp: int, fp: int, fn: int) -> float:
    if tp == 0:
        return 1.0 if fp == 0 and fn == 0 else 0.0
    return 2.0 * tp / (2 * tp + fp + fn)


def _match_notes(gt: MV2HScore, tr: MV2HScore) -> Dict[int, int]:
    """Greedy 1-1 note matching: same pitch, onset within ONSET_TOL_MS,
    closest-onset first. Returns {transcription index: gt index}."""
    candidates = []
    for ti, tn in enumerate(tr.notes):
        for gi, gn in enumerate(gt.notes):
            if tn.pitch == gn.pitch and abs(tn.on - gn.on) <= ONSET_TOL_MS:
                candidates.append((abs(tn.on - gn.on), ti, gi))
    candidates.sort()
    mapping: Dict[int, int] = {}
    used_gt = set()
    for _, ti, gi in candidates:
        if ti not in mapping and gi not in used_gt:
            mapping[ti] = gi
            used_gt.add(gi)
    return mapping


def _voice_links(score: MV2HScore) -> Dict[int, int]:
    """{note index -> previous note index in the same voice}, ordering
    notes within a voice by onset (ties by pitch for determinism)."""
    by_voice: Dict[int, List[int]] = {}
    order = sorted(range(len(score.notes)),
                   key=lambda i: (score.notes[i].on, score.notes[i].pitch))
    for i in order:
        by_voice.setdefault(score.notes[i].voice, []).append(i)
    prev: Dict[int, int] = {}
    for chain in by_voice.values():
        for a, b in zip(chain, chain[1:]):
            prev[b] = a
    return prev


def _voice_score(gt: MV2HScore, tr: MV2HScore,
                 mapping: Dict[int, int]) -> float:
    """F-measure over voice links among MATCHED notes: a transcription
    link is correct iff the two matched ground-truth notes are likewise
    consecutive within one ground-truth voice."""
    gt_prev = _voice_links(gt)
    tr_prev = _voice_links(tr)
    matched_gt = set(mapping.values())
    tr_links = [(p, n) for n, p in tr_prev.items()
                if n in mapping and p in mapping]
    gt_links = [(p, n) for n, p in gt_prev.items()
                if n in matched_gt and p in matched_gt]
    gt_link_set = set(gt_links)
    tp = sum((mapping[p], mapping[n]) in gt_link_set for p, n in tr_links)
    return _f1(tp, len(tr_links) - tp, len(gt_links) - tp)


def _groupings(score: MV2HScore) -> List[Tuple[int, int, int]]:
    """(level, start, end) metrical groupings from the tatum grid:
    level 0 = sub beat, 1 = beat, 2 = bar, phased by the anacrusis."""
    h = score.hierarchy
    t = score.tatums
    out: List[Tuple[int, int, int]] = []
    spans = [h.tatums_per_sub_beat,
             h.tatums_per_sub_beat * h.sub_beats_per_beat,
             h.tatums_per_sub_beat * h.sub_beats_per_beat * h.beats_per_bar]
    for level, span in enumerate(spans):
        start = h.anacrusis % span if h.anacrusis else 0
        i = start
        while i + span < len(t):
            out.append((level, t[i], t[i + span]))
            i += span
    return out


def _meter_score(gt: MV2HScore, tr: MV2HScore) -> float:
    gt_groups = _groupings(gt)
    tr_groups = _groupings(tr)
    unused = list(gt_groups)
    tp = 0
    for lvl, s, e in tr_groups:
        for k, (gl, gs, ge) in enumerate(unused):
            if gl == lvl and abs(s - gs) <= ONSET_TOL_MS \
                    and abs(e - ge) <= ONSET_TOL_MS:
                tp += 1
                del unused[k]
                break
    return _f1(tp, len(tr_groups) - tp, len(gt_groups) - tp)


def _value_score(gt: MV2HScore, tr: MV2HScore,
                 mapping: Dict[int, int]) -> float:
    """Mean duration accuracy over matched notes whose voice assignment
    is also correct (incoming voice link matches, or first-in-voice on
    both sides): max(0, 1 - |offset difference| / gt duration)."""
    if not mapping:
        return 1.0 if not gt.notes and not tr.notes else 0.0
    gt_prev = _voice_links(gt)
    tr_prev = _voice_links(tr)
    scores = []
    for ti, gi in mapping.items():
        tp_, gp = tr_prev.get(ti), gt_prev.get(gi)
        voice_ok = (tp_ is None and gp is None) or \
            (tp_ is not None and mapping.get(tp_) == gp)
        if not voice_ok:
            continue
        tn, gn = tr.notes[ti], gt.notes[gi]
        dur = max(gn.dur, 1)
        scores.append(max(0.0, 1.0 - abs(tn.val_off - gn.val_off) / dur))
    return sum(scores) / len(scores) if scores else 0.0


def _key_score(gt_key: Tuple[int, bool], tr_key: Tuple[int, bool]) -> float:
    """MIREX-style partial credit: exact 1.0, perfect fifth 0.5,
    relative major/minor 0.3, parallel 0.2, else 0."""
    (gt_t, gt_maj), (tr_t, tr_maj) = gt_key, tr_key
    if gt_t == tr_t and gt_maj == tr_maj:
        return 1.0
    if gt_maj == tr_maj and (tr_t - gt_t) % 12 in (5, 7):
        return 0.5
    if gt_maj != tr_maj:
        rel = (gt_t + 9) % 12 if gt_maj else (gt_t + 3) % 12
        if tr_t == rel:
            return 0.3
        if tr_t == gt_t:
            return 0.2
    return 0.0


def _progression(events, end: int, start_value):
    """[(start, end, value)] segments covering [0, end]."""
    segs = []
    current, t0 = start_value, 0
    for time, value in events:
        if time > t0 and current is not None:
            segs.append((t0, min(time, end), current))
        current, t0 = value, time
        if t0 >= end:
            break
    if current is not None and t0 < end:
        segs.append((t0, end, current))
    return segs


def _timeline_score(gt_events, tr_events, end: int, compare) -> float:
    """Time-weighted comparison of two piecewise-constant progressions
    over [0, end] (keys or chords), as the tool scores harmony."""
    if end <= 0:
        return 1.0
    gt_segs = _progression(gt_events, end, None)
    tr_segs = _progression(tr_events, end, None)
    total = 0.0
    for gs, ge, gv in gt_segs:
        for ts_, te, tv in tr_segs:
            lo, hi = max(gs, ts_), min(ge, te)
            if hi > lo:
                total += (hi - lo) * compare(gv, tv)
    covered = sum(ge - gs for gs, ge, _ in gt_segs)
    return total / covered if covered else 1.0


def _harmony_score(gt: MV2HScore, tr: MV2HScore) -> float:
    end = max(gt.end_time(), tr.end_time())
    parts = []
    if gt.keys or tr.keys:
        parts.append(_timeline_score(
            [(time, (t, m)) for t, m, time in gt.keys],
            [(time, (t, m)) for t, m, time in tr.keys],
            end, _key_score))
    if gt.chords or tr.chords:
        parts.append(_timeline_score(
            [(time, s) for time, s in gt.chords],
            [(time, s) for time, s in tr.chords],
            end, lambda a, b: 1.0 if a == b else 0.0))
    return sum(parts) / len(parts) if parts else 1.0


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

MV2H_KEYS = ["Multi-pitch", "Voice", "Meter", "Value", "Harmony", "MV2H"]


def evaluate_mv2h(gt: MV2HScore, tr: MV2HScore,
                  align: bool = True) -> Dict[str, float]:
    """The five component scores + their mean (the tool's stdout block).
    ``align=True`` is the -a flag: DTW-align the ground truth onto the
    transcription's time axis first."""
    if align:
        gt = _apply_time_map(gt, align_gt_times(gt, tr))
    mapping = _match_notes(gt, tr)
    tp = len(mapping)
    result = {
        "Multi-pitch": _f1(tp, len(tr.notes) - tp, len(gt.notes) - tp),
        "Voice": _voice_score(gt, tr, mapping),
        "Meter": _meter_score(gt, tr),
        "Value": _value_score(gt, tr, mapping),
        "Harmony": _harmony_score(gt, tr),
    }
    result["MV2H"] = sum(result.values()) / 5.0
    return result


def run_native_mv2h_pair(target_midi: str, pred_midi: str
                         ) -> Optional[Dict[str, float]]:
    """Native twin of run_mv2h_pair (same MIDI-pair contract, same
    result dict). Returns None on unreadable inputs, mirroring the
    subprocess wrapper's failure contract."""
    try:
        gt = midi_to_score(target_midi)
        tr = midi_to_score(pred_midi)
    except BaseException as exc:
        # Any error reading either file fails the pair; interrupts re-raise.
        if not isinstance(exc, Exception):
            raise
        return None
    return evaluate_mv2h(gt, tr, align=True)
