"""Humdrum/**kern parsing, cleaning, chunking and voice processing.

A copy of piano_a2s_tpu/symbolic/humdrum.py for the port: the kern
tokenizer of the data preparation (split, clean, target sequences) and
``kern_to_midi``, which score parsing and the synthetic corpus use. For the
same kern text every function here returns what the JAX package's does.

The observable behavior of every transform is that of the reference
pipeline (reference: data_processing/humdrum.py:190-839). The
implementation rests on three ideas the reference does not have:

  * a line classifier (`_kind`) + cell model instead of re-deriving
    ``startswith``/``split`` facts at every use site;
  * a ``SpineRegistry`` that tracks each live spine as (base type, split
    depth) through ``*^``/``*v`` lines, replacing string surgery on
    ``"**split"``-suffixed type names;
  * voice merging as interval-set algebra over ``Fraction`` onset/offset
    pairs (`_rhythm_intervals`) with small combining policies.

Reference quirks that parity forces us to keep are called out inline with
"quirk:" comments. One deliberate deviation: ``Kern.split`` returns an
empty list for scores shorter than one chunk where the reference raises
IndexError (its callers catch-and-skip; ours skip without the exception).
"""

from __future__ import annotations

import re
from fractions import Fraction
from itertools import cycle
from typing import List, Optional, Tuple

# Classic tempo words -> metronome marks (reference: humdrum.py:10-35).
CLASSIC_TEMPOS = {
    "grave": 32, "largoassai": 40, "largo": 50, "pocolargo": 60,
    "adagio": 71, "pocoadagio": 76, "andante": 92, "andantino": 100,
    "menuetto": 112, "moderato": 114, "pocoallegretto": 116,
    "allegretto": 118, "allegromoderato": 120, "pocoallegro": 124,
    "allegro": 130, "moltoallegro": 134, "allegroassai": 138,
    "vivace": 140, "vivaceassai": 150, "allegrovivace": 160,
    "allegrovivaceassai": 170, "pocopresto": 180, "presto": 186,
    "prestoassai": 200,
}

# A *numbered* barline ("=3", "==", "=12:|!"). NOTE: `[^-]*` matches the
# empty string, so "=3-invisible" DOES match too (only the suffix capture
# stops at the '-') — the exact behavior of the reference's regex, which
# measure counting and chunk boundaries are byte-for-byte pinned to. Do
# not "fix" this to actually exclude '-' barlines.
BARLINE_RE = re.compile(r"^=(\d+|=)[^-]*")

# One note inside a chord token: [tie-open] duration pitch [;pause] [tie].
_NOTE_RE = re.compile(r"(\[?)(\d+\.*)([a-gA-G]{1,4}[\-#]*)(;?)([\]_]?)")
_REST_RE = re.compile(r"(\[?)(\d+\.*)([r]{1,4}[\-#]*)")

# Line kinds.
_K_SPLIT = "split"      # contains *^ or *v (or *+ / *x) anywhere
_K_COMMENT = "comment"  # ! local/global comment
_K_INTERP = "interp"    # * interpretation (non-split)
_K_BARLINE = "barline"  # = barline
_K_DATA = "data"        # everything else

_SPLIT_ANY_RE = re.compile(r"\*[+x\^v]")
_SPLIT_VOICE_RE = re.compile(r"\*[\^v]")


def _kind(line: str) -> str:
    """Classify a body line.

    quirk: the split test runs on the WHOLE line before the comment test,
    so a comment whose text contains "*^" is treated as a split line —
    exactly like the reference's `re.search` ordering.
    """
    if _SPLIT_ANY_RE.search(line):
        return _K_SPLIT
    if line.startswith("!"):
        return _K_COMMENT
    if line.startswith("*"):
        return _K_INTERP
    if line.startswith("="):
        return _K_BARLINE
    return _K_DATA


def count_measure_segments(text: str) -> int:
    """Number of measures in kern text: segments separated by barlines that
    contain at least one data line. A pickup before the first numbered
    barline counts as a measure (music21-compatible counting)."""
    count = 0
    has_content = False
    for line in text.splitlines():
        if BARLINE_RE.match(line):
            if has_content:
                count += 1
            has_content = False
            continue
        if line and not line.startswith(("*", "!", "=")):
            has_content = True
    if has_content:
        count += 1
    return count


class Humdrum:
    """Split a Humdrum file into header / body / footer around the
    exclusive-interpretation (``**``) and terminator (``*-``) lines
    (reference: humdrum.py:190-212)."""

    def __init__(self, path=None, data: Optional[str] = None):
        if path is not None:
            data = path.read_text(encoding="iso-8859-1")
        lines = data.splitlines()
        # quirk: the LAST ** line wins as the body start; the FIRST *- line
        # ends the body.
        body_begin = body_end = 0
        for i, line in enumerate(lines):
            if line.startswith("**"):
                body_begin = i + 1
            if line.startswith("*-"):
                body_end = i
                break
        self.header = lines[:body_begin]
        self.footer = lines[body_end:]
        self.body = lines[body_begin:body_end]
        self.spine_types = self.header[-1].split("\t") if self.header else []

    def save(self, path):
        return path.write_text(self.dump(), encoding="iso-8859-1")

    def dump(self) -> str:
        return "\n".join(self.header + self.body + self.footer)


class SpineInfo:
    """Per-spine interpretation state: clef, key/time signature, tempo
    (reference: humdrum.py:215-269)."""

    FIELDS = ["type", "instrument", "clef", "keysig", "tonality", "timesig",
              "metronome"]

    # Dispatch table: (prefix, field). Longest prefixes first so *MM beats
    # *M and *k[ beats nothing else.
    _PREFIX_FIELDS = (("*k[", "keysig"), ("*clef", "clef"),
                      ("*I", "instrument"), ("*MM", "metronome"),
                      ("*M", "timesig"))

    def __init__(self, spine_types: List[str]):
        self.spines = [
            {"type": t, "instrument": "*", "clef": "*", "keysig": "*",
             "tonality": "*", "timesig": "*", "metronome": "*"}
            for t in spine_types
        ]

    def update(self, line: str) -> None:
        for i, item in enumerate(line.split("\t")):
            for prefix, field in self._PREFIX_FIELDS:
                if item.startswith(prefix):
                    self.spines[i][field] = item
                    break
            else:
                if item.startswith("*CT"):
                    self.spines[i]["metronome"] = \
                        f"*MM{CLASSIC_TEMPOS[item[3:]]}"
                elif item.endswith(":"):
                    self.spines[i]["tonality"] = item

    def override_instruments(self, instruments: List[str]) -> None:
        pool = cycle(instruments)
        inst = instruments[0]
        for spine in self.spines:
            if spine["type"] == "**kern":
                inst = next(pool)
            spine["instrument"] = f"*I{inst}"

    def dump(self) -> Tuple[List[str], List[str]]:
        header = ["\t".join(s[f] for s in self.spines) for f in self.FIELDS]
        footer = ["\t".join("*-" for _ in self.spines)]
        return header, footer

    def clone(self) -> "SpineInfo":
        out = SpineInfo([s["type"] for s in self.spines])
        # quirk: shallow — clones share the per-spine dicts, so updates on a
        # clone are visible through the original (reference semantics).
        out.spines = self.spines.copy()
        return out


class SpineRegistry:
    """Live spine list across ``*^`` (split) / ``*v`` (merge) lines.

    Each working spine is a ``[base_type, split_depth]`` pair; depth 0 is an
    original spine, depth k a k-times-split descendant. The reference
    tracks the same state as strings with "**split" suffixes; the depth
    integer is this module's equivalent.
    """

    def __init__(self, spine_types: List[str]):
        self.spines = [[t, 0] for t in spine_types]

    def __len__(self):
        return len(self.spines)

    def is_kern(self, i: int) -> bool:
        return self.spines[i][0].startswith("**kern")

    def is_split(self, i: int) -> bool:
        return self.spines[i][1] > 0

    def apply_marks(self, line: str) -> None:
        """Process one split-mark line (reference: humdrum.py:295-321).

        Merge-run semantics, matching the reference exactly:
          * the first ``*v`` of a run names the survivor, each further
            ``*v`` deletes its spine;
          * when a run is CLOSED by a later non-``*v`` cell, the survivor's
            depth is rewritten to the minimum depth seen;
          * quirk: that minimum accumulates across ALL runs on the line
            (it is never reset between runs);
          * quirk: a run that reaches end-of-line is never closed, so its
            survivor keeps its pre-merge depth.
        """
        spines = self.spines
        j = 0               # index into the working spine list
        in_run = False      # saw the survivor *v, later *v cells delete
        min_depth = 100     # line-global minimum (reference init value)
        for cell in line.split("\t"):
            if cell == "*^":
                spines.insert(j + 1, [spines[j][0], spines[j][1] + 1])
                j += 2      # skip the child we just created
                # quirk: a *^ does NOT close an open merge run — a *v after
                # it keeps deleting (reference else-branch never fires).
                continue
            if cell == "*v":
                min_depth = min(min_depth, spines[j][1])
                if in_run:
                    del spines[j]   # j now points at the next spine
                else:
                    in_run = True
                    j += 1
                continue
            if in_run:      # close the run: rewrite the survivor's depth
                spines[j - 1][1] = min_depth
                in_run = False
            j += 1


# Performance/notation marks the cleaner strips from kern tokens
# (reference: humdrum.py:344-372). Order of application matters only for
# the `cleaned` flag: ornaments are tested before the unconditional strips.
_ORNAMENT_RE = re.compile(r"[pTtMmWwS$O:]")
_BEAM_STEM_RE = re.compile(r"[JKkL\\/]")
_SLUR_MARK_RE = re.compile(r"[(){}xXyY&]")
_REST_TAIL_RE = re.compile(r"(\d*\.*r)(.*)")
_GRACE_RE = re.compile(r"[qQP]")
_PITCH_ANY_RE = re.compile(r"[A-Ga-g]")


def _scrub_token(token: str, remove_pauses: bool) -> Tuple[str, bool]:
    """Strip ornaments/beams/slurs from one kern data token.

    Returns (scrubbed, had_ornament) — had_ornament drives the caller's
    `cleaned` flag and is True only for the ornament class, as in the
    reference.
    """
    had_ornament = False
    if _ORNAMENT_RE.search(token):
        token = _ORNAMENT_RE.sub("", token)
        had_ornament = True
    if remove_pauses:
        token = token.replace(";", "")
    token = _BEAM_STEM_RE.sub("", token)
    token = _SLUR_MARK_RE.sub("", token)
    token = _REST_TAIL_RE.sub(r"\1", token)  # drop anything after a rest
    return token, had_ornament


class Kern(Humdrum):
    """A **kern score with cleaning, chunking, and flattening
    (reference: humdrum.py:271-528)."""

    def __init__(self, path=None, data: Optional[str] = None,
                 constrained: bool = False):
        super().__init__(path, data)
        self.constrained = constrained
        self.spines = SpineInfo(self.spine_types)
        # The body's leading interpretation block feeds SpineInfo; the first
        # non-interp (or split-mark) line starts the music.
        self.first_line = 0
        for i, line in enumerate(self.body):
            if not line.startswith("*") or _SPLIT_VOICE_RE.search(line):
                self.first_line = i
                break
            self.spines.update(line)

    # -- cleaning ----------------------------------------------------------

    def clean(self, remove_pauses: bool = True):
        """Remove ornaments/beams/slurs/grace notes; track spine splits.
        Returns (ok, cleaned_anything) — ok=False on unsupported spines
        (``*+``/``*x``) or on a line mixing grace notes with real notes."""
        registry = SpineRegistry(self.spine_types)
        n_original = len(registry)
        out: List[str] = []
        cleaned = False

        for line in self.body[self.first_line:]:
            if not line:
                continue
            kind = _kind(line)

            if kind == _K_SPLIT:
                cells = line.split("\t")
                if any(c.startswith(("*+", "*x")) for c in cells):
                    return False, None  # spine add/exchange unsupported
                registry.apply_marks(line)
                if not self.constrained:
                    out.append(line)
                continue

            cells = line.split("\t")
            # Constrained mode hides split-descendant columns whenever the
            # line is wider than the original spine count.
            def keep(i: int) -> bool:
                return not (self.constrained and registry.is_split(i)
                            and n_original < len(cells))

            if kind == _K_COMMENT:
                if self.constrained:
                    out.append("\t".join(
                        c for i, c in enumerate(cells) if keep(i)))
                else:
                    out.append(line)
                continue

            new_cells: List[str] = []
            saw_note = saw_grace = False
            for i, cell in enumerate(cells):
                if not keep(i):
                    continue
                if registry.is_kern(i) and not cell.startswith(("*", "=")):
                    if self.constrained:
                        cell = cell.split()[0]  # first chord note only
                    cell, had_ornament = _scrub_token(cell, remove_pauses)
                    cleaned = cleaned or had_ornament
                    if _GRACE_RE.search(cell):
                        saw_grace = True
                        cleaned = True
                    elif _PITCH_ANY_RE.search(cell):
                        saw_note = True
                new_cells.append(cell)

            if saw_grace:
                if saw_note:
                    return False, None  # grace+note on one line: give up
                continue                # pure grace line: drop it
            if not all(c == "." for c in new_cells) and \
                    not all(c == "!" for c in new_cells):
                out.append("\t".join(new_cells))

        header, _ = self.spines.dump()
        self.body = header[1:] + out
        self.first_line = len(header) - 1
        return True, cleaned

    # -- chunking ----------------------------------------------------------

    def _measure_starts(self) -> List[int]:
        """Body indices where measures begin: first_line, then the line
        after every numbered barline."""
        starts = [self.first_line]
        for i, line in enumerate(self.body[self.first_line:]):
            if BARLINE_RE.match(line):
                starts.append(i + self.first_line + 1)
        return starts

    def _restore_split_preamble(self, body: List[str], upto: int) -> None:
        """Prepend the interpretation lines that establish the spine-split
        state in effect at body line `upto`, scanning backwards until a
        line with the original spine width is found."""
        n_spines = len(self.spine_types)
        stack: List[str] = []
        for line in self.body[:upto][::-1]:
            if re.search(r"\*|:$", line):
                stack.append(line)
                if len(line.split("\t")) == n_spines:
                    break
        for line in stack:  # nearest-first insertion keeps file order
            body.insert(0, line)

    @staticmethod
    def _footer_for(body: List[str], footer: List[str]) -> List[str]:
        """Widen the ``*-`` footer to the width of the last non-comment
        body line."""
        last = -1
        while body[last].startswith("!"):
            last -= 1
        width = len(body[last].split("\t"))
        if len(footer[0].split("\t")) != width:
            return ["\t".join("*-" for _ in range(width))]
        return footer

    def split(self, chunk_size: int, stride: Optional[int] = None):
        """Cut into chunk_size-measure chunks (stride defaults to
        chunk_size), repairing spine-split headers/footers. quirk: the
        final chunk is dropped whenever the one after it would not fit
        (reference: humdrum.py:415-423 breaks before appending)."""
        stride = stride or chunk_size
        chunks: List[Kern] = []
        spines = self.spines.clone()
        starts = self._measure_starts()

        i = 0
        while i < len(starts) - 1:
            if i + chunk_size >= len(starts):
                break  # reference raises IndexError here; we just stop
            lo, hi = starts[i], starts[i + chunk_size]
            header, footer = spines.dump()
            i += stride
            if len(starts) - i - 1 < chunk_size:
                break  # drop the chunk in hand: the next one won't fit
            body = self.body[lo:hi]

            if not self.constrained:
                if len(self.spine_types) != len(body[0].split("\t")):
                    self._restore_split_preamble(body, lo)
                footer = self._footer_for(body, footer)

            chunks.append(Kern(data="\n".join(header + body + footer)))

            if self.constrained:
                # Advance the cloned interpretation state over the strided
                # region so the next chunk's header is current.
                for line in self.body[lo:starts[i]]:
                    if line.startswith("*"):
                        spines.update(line)
        return chunks

    # -- flattening --------------------------------------------------------

    # Characters allowed in the flattened token stream.
    _SEQ_STRIP_RE = re.compile(r"[^rA-Ga-g0-9.\[_\]#\-;\t ]")
    _DOUBLE_MARK_RE = re.compile(r"(#|-|\.){2,}")

    def tosequence(self) -> Optional[str]:
        """Flatten the body into token-ready text (barlines as '=', kern
        spines only, undefined symbols stripped). None if the result has
        double accidentals/dots (reference: humdrum.py:468-528)."""
        registry = SpineRegistry(self.spine_types)
        rows: List[str] = []
        for line in self.body[self.first_line:]:
            if line.startswith("="):
                if BARLINE_RE.match(line):
                    rows.append("=")
                continue
            if not self.constrained and _SPLIT_VOICE_RE.search(line):
                registry.apply_marks(line)
                continue
            if line.startswith(("*", "!")):
                continue
            stripped = self._SEQ_STRIP_RE.sub("", line)
            rows.append("\t".join(
                cell for i, cell in enumerate(stripped.split("\t"))
                if registry.is_kern(i)))

        seq = "\n".join(rows)
        if self._DOUBLE_MARK_RE.search(seq):
            return None  # double sharps/flats/dots unsupported
        return seq


# ---------------------------------------------------------------------------
# Pitch utilities
# ---------------------------------------------------------------------------

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


_PITCH_TOKEN_RE = re.compile(r"(?:[a-gA-G]{1,4}[\-#]*)")


def get_chords_pitches(chords: str) -> List[int]:
    """MIDI pitches of every note in a space-separated chord token."""
    pitches = []
    for note in chords.split(" "):
        m = _PITCH_TOKEN_RE.findall(note)
        if m:
            pitches.append(kern_to_midi(m[0]))
    return pitches


# ---------------------------------------------------------------------------
# Voice machinery
# ---------------------------------------------------------------------------

def _mean_pitch(rows: List[List[int]]) -> float:
    """Mean of per-row mean pitches; NaN when no row has a pitch (the NaN
    comparison then disables the swap, matching the reference)."""
    import numpy as np
    return np.mean([np.mean(r) for r in rows if len(r) > 0])


def sort_voices(kern: Kern):
    """Order two split voices by mean pitch (swap when the left voice is
    lower); returns the kern or False for >2 voices (reference:
    humdrum.py:530-560)."""
    open_split = False
    begin = 0
    left: List[List[int]] = []
    right: List[List[int]] = []

    def swap_region(begin: int, end: int):
        for j in range(begin, end):
            row = kern.body[j]
            if row.startswith("!"):
                continue
            cells = row.split("\t")
            if len(cells) < 2:
                continue
            if len(cells) > 2:
                return False
            kern.body[j] = "\t".join([cells[1], cells[0]] + cells[2:])
        return True

    for i, line in enumerate(kern.body):
        if not line.startswith("!") and len(line.split("\t")) > 2:
            return False
        if line.startswith("*^"):
            open_split = True
            begin = i + 1
            left, right = [], []
        elif line.startswith("*v") or (open_split
                                       and i == len(kern.body) - 1):
            open_split = False
            if _mean_pitch(left) < _mean_pitch(right):
                if swap_region(begin, i) is False:
                    return False
        if open_split and len(line.split("\t")) == 2:
            l_cell, r_cell = line.split("\t")
            left.append(get_chords_pitches(l_cell))
            right.append(get_chords_pitches(r_cell))
    return kern


def sort_chords(kern: Kern) -> Kern:
    """Sort chord notes by ascending MIDI pitch (reference:
    humdrum.py:562-586)."""
    for i, line in enumerate(kern.body):
        if line.startswith(("*", "!")):
            continue
        row = []
        for chord in line.split("\t"):
            notes = chord.split(" ")
            if len(notes) > 1:
                pitches = [kern_to_midi(m[0]) for note in notes
                           for m in [_PITCH_TOKEN_RE.findall(note)] if m]
                # quirk: the reference zips the (possibly shorter) pitch
                # list POSITIONALLY against the notes — an unpitched token
                # (e.g. a rest inside a chord) misaligns keys and truncates
                # the tail. Parity requires reproducing that.
                keyed = sorted(zip(pitches, notes), key=lambda kn: kn[0])
                row.append(" ".join(n for _, n in keyed))
            else:
                row.append(notes[0])
        kern.body[i] = "\t".join(row)
    return kern


def check_notes_existance(measure: List[str]) -> bool:
    """True if any chord token in the measure contains a pitched note."""
    return any(_NOTE_RE.search(note)
               for chord in measure for note in chord.split(" "))


def _duration(note_type: str) -> Fraction:
    """Whole-note fraction of a kern duration numeral ('4', '8.', ...)."""
    if note_type.endswith("."):
        base = int(note_type[:-1])
        return Fraction(1, base) + Fraction(1, 2 * base)
    return Fraction(1, int(note_type))


def _rhythm_intervals(voice: List[str]) -> set:
    """(onset, offset) interval set of a voice's first-note stream; rests
    advance time without emitting an interval."""
    intervals = set()
    t = Fraction(0)
    for chord in voice:
        head = chord.split(" ")[0]
        rest = _REST_RE.search(head)
        if rest:
            t += _duration(rest[2])
            continue
        m = _NOTE_RE.search(head)
        if m:
            end = t + _duration(m[2])
            intervals.add((str(t), str(end)))
            t = end
    return intervals


def check_single_voice(voice_l: List[str], voice_r: List[str]) -> int:
    """1/2 if one voice's onset-offset set contains the other's (so they
    can merge into chords), else 0 (reference: humdrum.py:639-673)."""
    assert len(voice_l) == len(voice_r)
    left, right = _rhythm_intervals(voice_l), _rhythm_intervals(voice_r)
    if right.issubset(left):
        return 1
    if left.issubset(right):
        return 2
    return 0


def _zip_voices(voice_l: List[str], voice_r: List[str], combine):
    """Walk two parallel voices; 'null' placeholders yield the other side,
    otherwise delegate to `combine(l, r)`."""
    out: List[str] = []
    for l_cell, r_cell in zip(voice_l, voice_r):
        if l_cell == "null":
            out.append(r_cell)
        elif r_cell == "null":
            out.append(l_cell)
        else:
            out.append(combine(l_cell, r_cell))
    return out


def merge_voices(voice_l: List[str], voice_r: List[str]):
    """Merge two parallel voice streams into one (chords) when rhythmically
    compatible, else keep two columns (reference: humdrum.py:675-734).

    Returns (merged_rows, n_columns)."""
    assert len(voice_l) == len(voice_r)
    has_l = check_notes_existance(voice_l)
    has_r = check_notes_existance(voice_r)

    if has_l and has_r:
        mode = check_single_voice(voice_l, voice_r)
        if mode == 0:       # rhythmically independent: keep two columns
            return _zip_voices(voice_l, voice_r,
                               lambda a, b: a + "\t" + b), 2
        if mode == 1:       # right fits inside left: chord into left
            return _zip_voices(
                voice_l, voice_r,
                lambda a, b: a + " " + b if _NOTE_RE.search(b) else a), 1
        return _zip_voices(   # left fits inside right: chord into right
            voice_l, voice_r,
            lambda a, b: b + " " + a if _NOTE_RE.search(a) else b), 1

    if not has_l and not has_r:
        # All-rest measure: keep whichever side has real cells.
        if "null" in voice_l:
            return voice_r, 1
        if "null" in voice_r:
            return voice_l, 1
        return [], 1

    # One voice has notes: keep it, but let the silent side fill its gaps.
    keep = list(voice_l if has_l else voice_r)
    other = voice_l if has_r else voice_r
    for i in range(len(keep)):
        # quirk: reference operator precedence — `a or (b and c)`:
        # a 'null' cell is always replaced, a '*' cell only when the other
        # side is not 'null'.
        if keep[i] == "null" or (keep[i] == "*" and other[i] != "null"):
            keep[i] = other[i]
    return keep, 1


def merge_whole_chunk(voices, n_voices):
    """Renumber measures and emit barlines matching each measure's column
    count; a 2-column measure after a 2-column measure gets a 2-column
    barline (reference: humdrum.py:736-758)."""
    assert len(voices) == len(n_voices)
    width = 1
    result: List[str] = []
    for i, rows in enumerate(voices):
        bar = f"={i + 1}"
        if width == 1 or n_voices[i] == 1:
            result.append(bar)
            width = n_voices[i]
        else:
            result.append(bar + "\t" + bar)
        result.extend(rows)
    result.append("=")
    return add_split_token(result)


def add_split_token(body: List[str]) -> List[str]:
    """Insert *^ / *v\t*v marks where the column count changes
    (reference: humdrum.py:760-772). quirk: comments are dropped."""
    out: List[str] = []
    prev = 1
    for line in body:
        if line.startswith("!"):
            continue
        cur = len(line.split("\t"))
        if (prev, cur) == (1, 2):
            out.append("*^")
        elif (prev, cur) == (2, 1):
            out.append("*v\t*v")
        out.append(line)
        prev = cur
    return out


def _segment_measures(body: List[str]):
    """Split a (cleaned, single-staff) body into the preamble and per-measure
    (voice_l, voice_r) streams; 1-column rows pair with 'null'.

    Returns (preamble, measures) or None when a row has >2 columns.
    Boundary rules replicate the reference (humdrum.py:774-819): a measure
    starts at each barline, or — before the first barline — at the first
    row whose successor is neither an interpretation nor a comment.
    """
    preamble: List[str] = []
    measures: List[Tuple[List[str], List[str]]] = []
    left: List[str] = []
    right: List[str] = []
    in_music = False       # past the first measure boundary
    saw_boundary = False   # the no-barline bootstrap fired already
    preamble_done = False

    for i, line in enumerate(body):
        if not in_music:
            # quirk: peeks at body[i+1]; the reference IndexErrors on a
            # truncated body — treat missing successor as end-of-preamble.
            nxt = body[i + 1] if i + 1 < len(body) else "="
            if nxt.startswith("=") or line.startswith("*^"):
                preamble_done = True
            if not preamble_done:
                preamble.append(line)

        is_boundary = line.startswith("=") or (
            not saw_boundary and i + 1 < len(body)
            and not body[i + 1].startswith(("*", "!")))
        if is_boundary:
            saw_boundary = True
            if in_music:
                measures.append((left, right))
            in_music = True
            left, right = [], []
            continue

        if line in ("*^", "*v\t*v"):
            continue

        if in_music:
            cells = line.split("\t")
            if len(cells) == 1:
                left.append(cells[0])
                right.append("null")
            elif len(cells) == 2:
                left.append(cells[0])
                right.append(cells[1])
            else:
                return None
    return preamble, measures


def process_voices(kern: Kern):
    """Merge 2-voice passages into single-voice chords where possible;
    returns a new Kern or False on >2 voices (reference:
    humdrum.py:774-819)."""
    segmented = _segment_measures(kern.body)
    if segmented is None:
        return False
    preamble, measures = segmented

    merged_rows, widths = [], []
    for left, right in measures:
        rows, width = merge_voices(left, right)
        if rows:
            merged_rows.append(rows)
            widths.append(width)

    music = merge_whole_chunk(merged_rows, widths)
    footer = [line.split("\t")[0] for line in kern.footer]
    return Kern(data="\n".join(kern.header + preamble + music + footer))


def eliminate_duplicate_chords(kern: Kern) -> Kern:
    """Deduplicate notes within each chord (set semantics, order not
    preserved — matches reference humdrum.py:821-839)."""
    for i, line in enumerate(kern.body):
        if line.startswith(("=", "*")):
            continue
        row = []
        for chord in line.split("\t"):
            notes = chord.split(" ")
            if len(notes) > 1:
                row.append(" ".join(n for n in set(notes) if n))
            else:
                row.append(notes[0])
        kern.body[i] = "\t".join(row)
    return kern
