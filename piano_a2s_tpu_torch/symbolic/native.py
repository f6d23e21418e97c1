"""Kern tool suite: spine extraction, transposition, tie repair.

A copy of piano_a2s_tpu/symbolic/native.py for the port: native C++
implementations (``native/kern_tools.cpp`` of this package, a copy of the
JAX package's source, loaded via ctypes) with pure-Python twins used where
no library can be built, and as the test oracle. These replace the
humextra CLI tools the reference shells out to:

  extract_spine  <- extractx -s N   (reference: render.py:73-74)
  transpose_kern <- transpose -t I  (reference: render.py:153-160)
  tiefix_kern    <- tiefix          (reference: render.py:104,
                                     humdrum.py:857, asap.py:144)

At first use the source is compiled with g++ (the flags of the JAX
package's native/CMakeLists.txt) into ``build/piano_a2s_tpu_torch/`` beside
the package, under a name that carries a hash of the source and the flags.
``KERN_TOOLS_NO_BUILD`` stops the build (a library already built is still
loaded); a build that fails warns with the compiler's output, and the
Python twins take over.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import warnings
from typing import List, Optional, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PACKAGE_DIR, "native", "kern_tools.cpp")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                         "piano_a2s_tpu_torch")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_lib = None
_build_failed = False  # warned once; the Python twins serve from then on


def library_path() -> str:
    """Where the library of SOURCE built with CXX_FLAGS lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkern_tools_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile SOURCE with g++ unless its library exists; returns the
    library's path. Raises RuntimeError with the compiler's output when
    there is no compiler or the build fails."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native kern tools "
                           "cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load_lib():
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        if os.environ.get("KERN_TOOLS_NO_BUILD") or _build_failed:
            return None
        try:
            path = build()
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _build_failed = True
            warnings.warn(f"native kern tools not built, using the Python "
                          f"twins: {exc}", RuntimeWarning, stacklevel=3)
            return None
    lib = ctypes.CDLL(path)
    for fn in ("kern_extract_spine", "kern_transpose", "kern_tiefix"):
        getattr(lib, fn).restype = ctypes.c_void_p
    lib.kern_extract_spine.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.kern_transpose.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.kern_tiefix.argtypes = [ctypes.c_char_p]
    lib.kern_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def _call_native(fn_name: str, *args) -> Optional[str]:
    lib = _load_lib()
    if lib is None:
        return None
    ptr = getattr(lib, fn_name)(*args)
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr).decode("iso-8859-1")
    finally:
        lib.kern_free(ptr)


# ---------------------------------------------------------------------------
# Pitch / interval arithmetic (Python twin of the C++)
# ---------------------------------------------------------------------------

_LETTER_SEMIS = [0, 2, 4, 5, 7, 9, 11]
_LETTERS = "CDEFGAB"
_MAJOR_SPAN = [0, 2, 4, 5, 7, 9, 11, 12]


def parse_interval(s: str) -> Tuple[int, int]:
    """'m2' / '-M3' / 'P1' / '0' -> (diatonic steps, chromatic semitones)."""
    if s in ("0", "", 0):
        return 0, 0
    s = str(s)
    sign = 1
    if s[0] in "+-":
        sign = -1 if s[0] == "-" else 1
        s = s[1:]
    quality, number = s[0], int(s[1:])
    d = number - 1
    base = _MAJOR_SPAN[d % 7] + 12 * (d // 7)
    if quality in ("P", "M"):
        c = base
    elif quality == "m":
        c = base - 1
    elif quality == "A":
        c = base + 1
    elif quality == "d":
        c = base - (1 if d % 7 in (0, 3, 4) else 2)
    else:
        raise ValueError(f"bad interval {s}")
    return sign * d, sign * c


def _parse_pitch(s: str):
    m = re.fullmatch(r"([a-gA-G])\1*([#\-]*)", s)
    if not m:
        return None
    base = s[0]
    count = len(s) - len(m.group(2))
    letter = _LETTERS.index(base.upper())
    octave = 3 + count if base.islower() else 4 - count
    alter = m.group(2).count("#") - m.group(2).count("-")
    return letter, octave, alter


def _pitch_str(letter: int, octave: int, alter: int) -> str:
    ch = _LETTERS[letter]
    if octave >= 4:
        out = ch.lower() * (octave - 3)
    else:
        out = ch * (4 - octave)
    return out + ("#" * alter if alter > 0 else "-" * (-alter))


def _transpose_pitch(letter, octave, alter, d, c):
    diat = octave * 7 + letter + d
    new_oct, new_letter = divmod(diat, 7)
    chroma = octave * 12 + _LETTER_SEMIS[letter] + alter + c
    new_alter = chroma - (new_oct * 12 + _LETTER_SEMIS[new_letter])
    return new_letter, new_oct, new_alter


_PITCH_IN_NOTE = re.compile(r"([a-gA-G])\1*[#\-]*")
_SHARP_ORDER = ["f#", "c#", "g#", "d#", "a#", "e#", "b#"]
_FLAT_ORDER = ["b-", "e-", "a-", "d-", "g-", "c-", "f-"]


class _SpineMap:
    """Column tracking through *^ / *v manipulators.

    Each column carries TWO identities: its ROOT spine (the header spine it
    descends from — what extraction and spine-type checks need) and its
    BRANCH id (unique per split branch — what tie chains need so sibling
    unison ties never interleave). Files without a ** header default every
    column to kern (bare fragments in tests/pipelines)."""

    def __init__(self):
        self.cols: List[tuple] = []  # (root_id, branch_id) per column
        self.types: dict = {}
        self.started = False

    def start(self, header_cols: List[str]) -> None:
        self.cols = [(i + 1, i + 1) for i in range(len(header_cols))]
        self.types = {i + 1: t for i, t in enumerate(header_cols)}
        self._next = len(header_cols) + 1  # fresh branch ids
        self.started = True

    def root(self, ci: int) -> int:
        if not self.started:
            return ci + 1
        return self.cols[ci][0] if ci < len(self.cols) else 0

    def spine(self, ci: int) -> int:
        """Branch identity (stable across *^/*v for the primary branch)."""
        if not self.started:
            return ci + 1
        return self.cols[ci][1] if ci < len(self.cols) else 0

    def is_kern(self, ci: int) -> bool:
        if not self.started:
            return True
        return self.types.get(self.root(ci), "").startswith("**kern")

    @staticmethod
    def is_manip_line(items: List[str]) -> bool:
        return any(x in ("*^", "*v", "*+", "*x") for x in items)

    def apply_manip(self, items: List[str]) -> bool:
        """Apply one manipulator line. False on unsupported *+ / *x
        (column identities would be wrong afterwards)."""
        if any(x in ("*+", "*x") for x in items):
            return False
        if not self.started:
            return True
        nxt: List[tuple] = []
        in_merge_run = False
        for idx, item in enumerate(items):
            pair = self.cols[idx] if idx < len(self.cols) else (0, 0)
            if item == "*v":
                if not in_merge_run:
                    nxt.append(pair)  # merged column keeps the first ids
                in_merge_run = True
                continue
            in_merge_run = False
            if item == "*^":
                # First branch keeps the parent branch id (ties may span
                # the split); the second gets a fresh branch id.
                nxt.append(pair)
                nxt.append((pair[0], self._next))
                self._next += 1
            else:
                nxt.append(pair)
        self.cols = nxt
        return True


def _py_transpose(data: str, interval: str) -> str:
    d, c = parse_interval(interval)
    fifths_delta = 7 * c - 12 * d
    out_lines: List[str] = []
    smap = _SpineMap()
    for line in data.split("\n"):
        if line.startswith("**"):
            smap.start(line.split("\t"))
            out_lines.append(line)
            continue
        if line.startswith(("!", "=")):
            out_lines.append(line)
            continue
        items = line.split("\t")
        if line.startswith("*") and _SpineMap.is_manip_line(items):
            if not smap.apply_manip(items):
                raise ValueError(
                    "unsupported spine manipulators *+/*x in kern input")
            out_lines.append(line)
            continue
        cols = []
        for ci, col in enumerate(items):
            if not smap.is_kern(ci):
                cols.append(col)  # never transpose non-**kern spines
                continue
            if col.startswith("*k["):
                sharps = col.count("#")
                flats = col.count("-")
                fifths = sharps if sharps else -flats
                fifths += fifths_delta
                while fifths > 7:
                    fifths -= 12
                while fifths < -7:
                    fifths += 12
                order = _SHARP_ORDER if fifths > 0 else _FLAT_ORDER
                cols.append("*k[" + "".join(order[:abs(fifths)]) + "]")
                continue
            if len(col) >= 2 and col[0] == "*" and col.endswith(":"):
                tonic = col[1:-1]
                p = _parse_pitch(tonic)
                if p:
                    nl, _, na = _transpose_pitch(*p, d, c)
                    # Tonality case encodes MODE (major/minor) — preserve
                    # the input's case, never derive it from the octave.
                    letter = _LETTERS[nl]
                    if tonic[0].islower():
                        letter = letter.lower()
                    acc = "#" * na if na > 0 else "-" * (-na)
                    cols.append("*" + letter + acc + ":")
                    continue
                cols.append(col)
                continue
            if col.startswith("*") or col == ".":
                cols.append(col)
                continue
            notes = []
            for note in col.split(" "):
                if re.search(r"r", note.split("#")[0].split("-")[0]) and \
                        not _PITCH_IN_NOTE.search(note):
                    notes.append(note)
                    continue
                m = _PITCH_IN_NOTE.search(note)
                if not m or "r" in note[:m.start()]:
                    notes.append(note)
                    continue
                p = _parse_pitch(m.group(0))
                if p is None:
                    notes.append(note)
                    continue
                nl, no, na = _transpose_pitch(*p, d, c)
                notes.append(note[:m.start()] + _pitch_str(nl, no, na)
                             + note[m.end():])
            cols.append(" ".join(notes))
        out_lines.append("\t".join(cols))
    result = "\n".join(out_lines)
    return result if result.endswith("\n") else result + "\n"


def _py_extract_spine(data: str, spine: int) -> str:
    smap = _SpineMap()
    out: List[str] = []
    lines = data.split("\n")
    for i, line in enumerate(lines):
        if line.startswith("!!") or line == "":
            # keep interior blank lines; drop only the trailing one from
            # the final newline (matches the C++ implementation)
            if line or i < len(lines) - 1:
                out.append(line)
            continue
        cols = line.split("\t")
        if not smap.started and line.startswith("**"):
            smap.start(cols)
        kept = [cols[ci] for ci in range(len(cols))
                if smap.started and ci < len(smap.cols)
                and smap.root(ci) == spine]
        if smap.started and _SpineMap.is_manip_line(cols):
            if any(k in ("*^", "*v") for k in kept) and kept and \
                    not (len(kept) == 1 and kept[0] == "*v"):
                out.append("\t".join(kept))
            if not smap.apply_manip(cols):
                raise ValueError(
                    "unsupported spine manipulators *+/*x in kern input")
            continue
        if kept:
            out.append("\t".join(kept))
    return "\n".join(out) + "\n"


def _py_tiefix(data: str) -> str:
    lines = data.split("\n")
    parsed = {}
    chains = {}
    smap = _SpineMap()
    for li, line in enumerate(lines):
        if line.startswith("**") and not smap.started:
            smap.start(line.split("\t"))
            continue
        if line.startswith("*"):
            items = line.split("\t")
            if _SpineMap.is_manip_line(items):
                if not smap.apply_manip(items):
                    raise ValueError(
                        "unsupported spine manipulators *+/*x in kern input")
            continue
        if not line or line[0] in "!=":
            continue
        cols = line.split("\t")
        notes_by_col = [col.split(" ") for col in cols]
        parsed[li] = notes_by_col
        for ci, notes in enumerate(notes_by_col):
            for ni, n in enumerate(notes):
                if not n or n == ".":
                    continue
                has_open = n.startswith("[")
                has_cont = "_" in n
                has_close = "]" in n
                if not (has_open or has_cont or has_close):
                    continue
                m = _PITCH_IN_NOTE.search(n)
                if not m or "r" in n[:m.start()]:
                    continue
                # Chains follow SPINES (stable across *^/*v), not columns.
                chains.setdefault((smap.spine(ci), m.group(0)), []).append(
                    [li, ci, ni, has_open, has_cont, has_close])
    strip = set()
    convert = set()  # dangling '_' becomes ']' (ends the tie legally)
    for refs in chains.values():
        open_tie = False
        for j, (li, ci, ni, op, cont, close) in enumerate(refs):
            if (cont or close) and not open_tie:
                if cont:
                    strip.add((li, ci, ni, "_"))
                if close:
                    strip.add((li, ci, ni, "]"))
                cont = close = False
            if close:
                open_tie = False
            if op or cont:
                consumed = j + 1 < len(refs) and (refs[j + 1][4]
                                                  or refs[j + 1][5])
                if consumed:
                    open_tie = True
                else:
                    if cont:
                        convert.add((li, ci, ni))
                    elif op:
                        strip.add((li, ci, ni, "["))
                    open_tie = False
    out = []
    for li, line in enumerate(lines):
        if li not in parsed:
            out.append(line)
            continue
        cols = []
        for ci, notes in enumerate(parsed[li]):
            fixed = []
            for ni, n in enumerate(notes):
                for flag in "[_]":
                    if (li, ci, ni, flag) in strip:
                        n = n.replace(flag, "", 1)
                if (li, ci, ni) in convert:
                    n = n.replace("_", "]", 1)
                fixed.append(n)
            cols.append(" ".join(fixed))
        out.append("\t".join(cols))
    result = "\n".join(out)
    if not result.endswith("\n"):
        result += "\n"
    return result


# ---------------------------------------------------------------------------
# Public API: native first, Python fallback
# ---------------------------------------------------------------------------

def _reject_unsupported(kern_text: str) -> None:
    """Reject *+/*x spine manipulators — but only as actual spine CELLS
    (a substring check would also fire on comments/reference records like
    '!! merged via *x', which the humextra tools and Kern.clean's
    startswith-based check both accept; reference: humdrum.py:330-333)."""
    for line in kern_text.splitlines():
        if line.startswith(("!", "=")) or not line.startswith("*"):
            continue
        for cell in line.split("\t"):
            if cell in ("*+", "*x"):
                raise ValueError(
                    "unsupported spine manipulators *+/*x in kern input")


def extract_spine(kern_text: str, spine: int) -> str:
    """Extract 1-based spine N (extractx -s N). Raises ValueError on
    unsupported *+/*x manipulators."""
    _reject_unsupported(kern_text)
    res = _call_native("kern_extract_spine",
                       kern_text.encode("iso-8859-1"), spine)
    return res if res is not None else _py_extract_spine(kern_text, spine)


def transpose_kern(kern_text: str, interval: str) -> str:
    """Diatonic transposition by interval string (transpose -t I). Raises
    ValueError on unsupported *+/*x manipulators."""
    _reject_unsupported(kern_text)
    res = _call_native("kern_transpose", kern_text.encode("iso-8859-1"),
                       str(interval).encode())
    return res if res is not None else _py_transpose(kern_text,
                                                     str(interval))


def tiefix_kern(kern_text: str) -> str:
    """Repair dangling ties (tiefix). Raises ValueError on unsupported
    *+/*x manipulators."""
    _reject_unsupported(kern_text)
    res = _call_native("kern_tiefix", kern_text.encode("iso-8859-1"))
    return res if res is not None else _py_tiefix(kern_text)
