"""Offline synthesis pipeline: scores -> chunks -> targets -> MIDI -> audio
-> spectrograms.

A copy of piano_a2s_tpu/data/render.py for the port: for the same inputs
(and the same external tools on PATH) every stage writes the same files.
The feature pass runs the port's host VQT twin (``ops.vqt.get_vqt_host``);
``write_features``, its work on one clip, is shared with the ASAP pass
(``data/asap.py``).

Port of the reference's data_processing/render.py with native replacements:
spine extraction / tie repair / transposition via our kern tools (C++ or
Python; no humextra), key/time signatures tracked directly from the kern
text (no hum2xml/music21 round-trip), MusicXML written by our writer, and
loudness normalization via our BS.1770 implementation. External tools kept
behind subprocess wrappers where they are genuinely external: verovio
(MusicXML<->kern conversion, score-MIDI), FluidSynth (audio synthesis),
virtuosoNet (expressive 'EPR' MIDI; the native engine in ``epr_native``
covers hosts without it).

Stage map (reference render.py:564-604):
  convert_xml_to_kern -> preprocess_kern -> split_datasets -> xml_to_midi
  -> clean_files -> render_all_midi -> prepare_spectrograms
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..symbolic.humdrum import (BARLINE_RE as _BARLINE_RE, Kern,
                                process_voices, sort_chords, sort_voices)
from ..symbolic.native import extract_spine, tiefix_kern, transpose_kern
from ..symbolic.vocab import LabelsMultiple
from ..ops.vqt import VQTConfig, get_vqt_host
from ..utils.audio import read_wav, resample, to_pcm16
from .audio_fx import Compressor, normalize_rendered_audio
from .datasets import load_time_signatures

# Random-transposition table per original key (reference: render.py:27-41):
# intervals that keep the resulting key inside [-6, 7] fifths.
FEASIBLE_TRANSPOSES: Dict[int, list] = {
    -6: [0, "-m2", "-m3", "M2", "M3"],
    -5: [0, "-m2", "-m3", "M2", "M3"],
    -4: [0, "-m2", "-M2", "-m3", "M2", "M3"],
    -3: [0, "-m2", "-M2", "-m3", "M2", "m3", "M3"],
    -2: [0, "-m2", "-M2", "-m3", "-M3", "M2", "m3", "M3"],
    -1: [0, "-m2", "-M2", "-m3", "-M3", "m2", "M2", "m3", "M3"],
    0: [0, "-m2", "-M2", "-m3", "-M3", "m2", "M2", "m3", "M3"],
    1: [0, "-m2", "-M2", "-m3", "-M3", "m2", "M2", "m3", "M3"],
    2: [0, "-m2", "-M2", "-m3", "-M3", "m2", "M2", "m3", "M3"],
    3: [0, "-M2", "-m3", "-M3", "m2", "M2", "m3", "M3"],
    4: [0, "-M2", "-m3", "-M3", "m2", "M2", "m3"],
    5: [0, "-M2", "-M3", "m2", "M2", "m3"],
    6: [0, "-M2", "-M3", "m2", "m3"],
    7: [0, "-M2", "-M3", "m2", "m3"],
}

TRAIN_SOUNDFONTS = ["TimGM6mb.sf2", "FluidR3_GM.sf2",
                    "UprightPianoKW-20220221.sf2",
                    "SalamanderGrandPiano-V3+20200602.sf2"]
TEST_SOUNDFONTS = ["UprightPianoKW-20220221.sf2",
                   "SalamanderGrandPiano-V3+20200602.sf2",
                   "YDP-GrandPiano-20160804.sf2"]
TRAIN_COMPOSERS = ["score", "Bach", "Balakirev", "Beethoven", "Brahms",
                   "Debussy", "Glinka", "Haydn", "Liszt", "Prokofiev",
                   "Rachmaninoff", "Ravel", "Schubert", "Schumann",
                   "Scriabin"]
TEST_COMPOSERS = ["score", "Bach", "Mozart", "Chopin"]


def _mkdirs(*paths: str) -> None:
    for p in paths:
        os.makedirs(p, exist_ok=True)


def have_tool(name: str) -> bool:
    return shutil.which(name) is not None


# ---------------------------------------------------------------------------
# Kern-side helpers (native)
# ---------------------------------------------------------------------------

def get_staff_spines(kern_text: str) -> Tuple[int, int]:
    """1-based indices of the two **kern spines (lower, upper)
    (reference: render.py:43-50)."""
    for line in kern_text.splitlines():
        if line.startswith("**"):
            spines = line.split("\t")
            idx = [i for i, x in enumerate(spines) if x == "**kern"]
            return idx[0] + 1, idx[1] + 1
    raise ValueError("no exclusive interpretation line")


_KEYSIG_RE = re.compile(r"\*k\[([a-g#\-]*)\]")
_TIMESIG_RE = re.compile(r"\*M(\d+)/(\d+)")


def measure_signatures(kern_text: str
                       ) -> List[Tuple[Optional[int], Optional[str]]]:
    """Per-measure (key_fifths, time_sig) tracked from the kern text —
    replaces the reference's music21 measure walk (render.py:215-218).
    Entries are None until the first signature appears.

    A measure's signatures are the values in effect at its first CONTENT
    line: interpretation lines between a barline and the following content
    (e.g. '=2' then '*M3/4') belong to the NEW measure."""
    key: Optional[int] = None
    time: Optional[str] = None
    sigs: List[Tuple[Optional[int], Optional[str]]] = []
    measure_finalized = False  # current measure already got its sigs
    for line in kern_text.splitlines():
        m = _KEYSIG_RE.search(line)
        if m:
            acc = m.group(1)
            sharps = acc.count("#")
            flats = acc.count("-")
            key = sharps if sharps else -flats
        m = _TIMESIG_RE.search(line)
        if m:
            time = f"{m.group(1)}/{m.group(2)}"
        if _BARLINE_RE.match(line):
            if not measure_finalized:
                # previous measure had no content; close it with current sigs
                sigs.append((key, time))
            measure_finalized = False
            continue
        if not line.startswith(("*", "!", "=")) and line.strip():
            if not measure_finalized:
                sigs.append((key, time))
                measure_finalized = True
    return sigs


def count_measures(kern_text: str) -> int:
    return sum(1 for line in kern_text.splitlines()
               if _BARLINE_RE.match(line))


# ---------------------------------------------------------------------------
# Stage 3: split scores into chunks + targets
# ---------------------------------------------------------------------------

def split_single_score(score_path: str, feature_folder: str,
                       labels: LabelsMultiple, time_sig_list: List[str],
                       split: str = "train", version: int = 0,
                       chunk_size: int = 5, rng=None) -> int:
    """One kern score -> 5-bar chunks with targets (reference:
    render.py:52-233). Returns the number of targets written."""
    rng = rng or np.random.RandomState()
    score_name = os.path.basename(score_path).split(".")[0]
    output_dir = os.path.join(feature_folder, split, str(version))
    for d in ("midi", "wav", "kern", "xml", "target", "kern_upper",
              "kern_lower", "info"):
        _mkdirs(os.path.join(output_dir, d))

    with open(score_path, encoding="iso-8859-1") as f:
        score_text = f.read()
    try:
        spine_lower, spine_upper = get_staff_spines(score_text)
    except (ValueError, IndexError):
        return 0
    try:
        lower = Kern(data=extract_spine(score_text, spine_lower))
        upper = Kern(data=extract_spine(score_text, spine_upper))
    except ValueError:
        return 0  # unsupported *+/*x manipulators: skip the score
    full = Kern(data=score_text)
    for kern in (lower, upper, full):
        ok, _ = kern.clean()
        if not ok:
            return 0

    stride = 2 if split == "train" else chunk_size
    chunk_lists = []
    for kern in (lower, upper, full):
        try:
            chunk_lists.append(kern.split(chunk_size, stride))
        except BaseException as exc:
            if not isinstance(exc, Exception):  # interrupts
                raise
            return 0
    n = min(len(c) for c in chunk_lists)

    written = 0
    for j in range(n):
        names = {}
        for kern_chunk, sub in zip((chunk_lists[0][j], chunk_lists[1][j],
                                    chunk_lists[2][j]),
                                   ("kern_lower", "kern_upper", "kern")):
            try:
                fixed = tiefix_kern(kern_chunk.dump())
            except ValueError:
                fixed = kern_chunk.dump()  # leave ties as-is on odd input
            path = os.path.join(output_dir, sub, f"{score_name}.{j}.krn")
            with open(path, "w", encoding="iso-8859-1") as f:
                f.write(fixed)
            names[sub] = path
        written += _build_chunk_target(
            names, f"{score_name}.{j}", output_dir, labels, time_sig_list,
            split, chunk_size, rng)
    return written


def _build_chunk_target(paths: Dict[str, str], chunk_id: str,
                        output_dir: str, labels: LabelsMultiple,
                        time_sig_list: List[str], split: str,
                        chunk_size: int, rng) -> int:
    info: Dict[str, object] = {"score_name": chunk_id.rsplit(".", 1)[0],
                               "chunk": chunk_id + ".krn"}
    with open(paths["kern"], encoding="iso-8859-1") as f:
        full_text = f.read()
    # The reference parses each chunk through music21 .expandRepeats()
    # and rejects when the expanded measure count != chunk_size
    # (render.py:135-142) — which in practice drops chunks carrying
    # REPEAT barlines (expansion duplicates their measures). Kern.split
    # always yields exactly chunk_size barlines, so a raw count can't
    # discriminate; detect the repeat glyphs on barlines instead.
    if count_measures(full_text) != chunk_size:
        return 0
    for line in full_text.splitlines():
        if _BARLINE_RE.match(line) and ":" in line.split("\t")[0]:
            return 0  # repeat barline: expandRepeats() would diverge
    sigs = measure_signatures(full_text)
    original_key = sigs[0][0] if sigs and sigs[0][0] is not None else 0

    # Random feasible transposition (train only; reference render.py:146-164)
    if split == "train" and original_key in FEASIBLE_TRANSPOSES:
        interval = rng.choice(FEASIBLE_TRANSPOSES[original_key])
        info["original_key"] = int(original_key)
        info["transpose"] = str(interval)
        if interval != 0 and interval != "0":
            try:
                for key_ in ("kern_lower", "kern_upper", "kern"):
                    with open(paths[key_], encoding="iso-8859-1") as f:
                        text = f.read()
                    transposed = transpose_kern(text, str(interval))
                    with open(paths[key_], "w", encoding="iso-8859-1") as f:
                        f.write(transposed)
            except ValueError:
                return 0  # unsupported manipulators: skip the chunk
            with open(paths["kern"], encoding="iso-8859-1") as f:
                full_text = f.read()
            sigs = measure_signatures(full_text)
    else:
        info["original_key"] = int(original_key)
        info["transpose"] = 0

    with open(paths["kern_lower"], encoding="iso-8859-1") as f:
        lower = Kern(data=f.read())
    with open(paths["kern_upper"], encoding="iso-8859-1") as f:
        upper = Kern(data=f.read())

    # Write MusicXML for the downstream MIDI synthesis (our writer replaces
    # the hum2xml + music21 round-trip).
    xml_path = os.path.join(output_dir, "xml", f"{chunk_id}.xml")
    try:
        _write_chunk_xml(upper, lower, sigs, xml_path)
    except BaseException as exc:
        if not isinstance(exc, Exception):  # interrupts
            raise
        return 0

    # Target token sequences (reference render.py:180-228).
    try:
        lower_p = process_voices(lower)
        upper_p = process_voices(upper)
    except BaseException as exc:
        if not isinstance(exc, Exception):  # interrupts
            raise
        return 0
    if lower_p is False or upper_p is False:
        return 0
    try:
        lower_p = sort_voices(sort_chords(lower_p))
        upper_p = sort_voices(sort_chords(upper_p))
    except BaseException as exc:
        if not isinstance(exc, Exception):  # interrupts
            raise
        return 0
    if lower_p is False or upper_p is False:
        return 0
    lower_seq = lower_p.tosequence()
    upper_seq = upper_p.tosequence()
    if lower_seq is None or upper_seq is None:
        return 0

    from ..symbolic.export import split_sequence_bars
    lower_bars = split_sequence_bars(lower_seq)
    upper_bars = split_sequence_bars(upper_seq)
    if len(lower_bars) < chunk_size or len(upper_bars) < chunk_size:
        return 0
    target = []
    current_key, current_time = None, None
    for m in range(chunk_size):
        k, t = sigs[m] if m < len(sigs) else (None, None)
        current_key = k if k is not None else current_key
        current_time = t if t is not None else current_time
        if current_time not in time_sig_list:
            return 0
        if current_key is None or current_key < -6 or current_key > 7:
            return 0
        try:
            target.append([current_key, current_time,
                           labels.encode(lower_bars[m]),
                           labels.encode(upper_bars[m])])
        except BaseException as exc:
            if not isinstance(exc, Exception):  # interrupts
                raise
            return 0
    with open(os.path.join(output_dir, "target", f"{chunk_id}.pkl"),
              "wb") as f:
        pickle.dump(target, f)
    with open(os.path.join(output_dir, "info", f"{chunk_id}.json"),
              "w") as f:
        json.dump(info, f, indent=2)
    return 1


def _write_chunk_xml(upper: Kern, lower: Kern, sigs, xml_path: str) -> None:
    from ..symbolic.export import part_from_kern_text
    from ..symbolic.musicxml import write_musicxml
    from ..symbolic.score import Score
    keys = [k if k is not None else 0 for k, _ in sigs]
    times = [t if t is not None else "4/4" for _, t in sigs]
    up_seq = upper.tosequence() or ""
    low_seq = lower.tosequence() or ""
    up = part_from_kern_text(up_seq, keys, times, clef="treble")
    low = part_from_kern_text(low_seq, keys, times, clef="bass")
    write_musicxml(Score(parts=[up, low]), xml_path)


def split_datasets(versions: Sequence[int], feature_folder: str,
                   kern_folder: str = "data_processing/kern",
                   metadata_dir: Optional[str] = None,
                   seed: int = 0) -> None:
    """Map every score into train/valid/test chunk sets for each version
    (reference: render.py:235-272)."""
    from .datasets import load_split_list
    labels = LabelsMultiple(extended=True)
    time_sig_list = load_time_signatures()
    test_songs = set(load_split_list("test_split.txt")[1:])
    val_songs = set(load_split_list("valid_split.txt")[1:])
    score_paths = sorted(
        os.path.join(kern_folder, f) for f in os.listdir(kern_folder))
    for v in versions:
        rng = np.random.RandomState(seed + 1000 * int(v))
        for score_path in score_paths:
            score_name = os.path.basename(score_path).split(".")[0]
            if score_name in test_songs and v == 0:
                split = "test"
            elif score_name in val_songs and v == 0:
                split = "valid"
            elif score_name not in test_songs and score_name not in val_songs:
                split = "train"
            else:
                continue
            split_single_score(score_path, feature_folder, labels,
                               time_sig_list, split=split, version=int(v),
                               rng=rng)


# ---------------------------------------------------------------------------
# Stage 1-2: external conversions (verovio / hum2xml wrappers)
# ---------------------------------------------------------------------------

def convert_xml_to_kern(xml_folder: str, kern_folder: str) -> int:
    """MuseSyn MusicXML -> kern via verovio (reference: render.py:457-463)."""
    if not have_tool("verovio"):
        raise RuntimeError("verovio not found on PATH")
    _mkdirs(kern_folder)
    n = 0
    for xml_file in sorted(os.listdir(xml_folder)):
        if not xml_file.endswith(".xml"):
            continue
        kern_path = os.path.join(kern_folder,
                                 xml_file.replace(".xml", ".krn"))
        r = subprocess.run(
            ["verovio", "-f", "musicxml-hum", "-t", "hum",
             os.path.join(xml_folder, xml_file), "-o", kern_path],
            capture_output=True)
        n += r.returncode == 0
    return n


def preprocess_kern(kern_folder: str) -> None:
    """Filter Chopin scores by the selected list; re-normalize Joplin
    scores through hum2xml+verovio (reference: render.py:465-489)."""
    from .datasets import load_split_list
    selected_chopin = set(load_split_list("selected_chopin.txt")[1:])
    for kern_file in sorted(os.listdir(kern_folder)):
        path = os.path.join(kern_folder, kern_file)
        if kern_file.startswith("chopin"):
            if kern_file[:-4].split("#")[-1] not in selected_chopin:
                os.remove(path)
        elif kern_file.startswith("joplin"):
            if kern_file == "joplin#school.krn":
                os.remove(path)
                continue
            if have_tool("hum2xml") and have_tool("verovio"):
                tmp_xml = path + ".tmp.xml"
                with open(tmp_xml, "w") as f:
                    r = subprocess.run(["hum2xml", path], stdout=f,
                                       stderr=subprocess.DEVNULL)
                if r.returncode != 0:
                    os.remove(path)
                    os.remove(tmp_xml)
                    continue
                r = subprocess.run(["verovio", "-f", "musicxml-hum", "-t",
                                    "hum", tmp_xml, "-o", path],
                                   capture_output=True)
                os.remove(tmp_xml)
                if r.returncode != 0:
                    os.remove(path)


# ---------------------------------------------------------------------------
# Stage 4: MusicXML -> MIDI (verovio score-MIDI or virtuosoNet EPR)
# ---------------------------------------------------------------------------

def xml_to_midi(versions: Sequence[int], feature_folder: str,
                midi_syn: str = "score", seed: int = 0,
                epr_generate=None) -> None:
    """Render each chunk's MusicXML to MIDI with tempo augmentation
    (reference: render.py:387-455). midi_syn='score' uses verovio;
    'epr' uses virtuosoNet via the injected `epr_generate(xml_path,
    composer) -> midi_path` callable."""
    assert midi_syn in ("epr", "score")
    if midi_syn == "epr" and epr_generate is None:
        # Fail fast: inside the per-file loop this error would be swallowed
        # by the skip-and-continue policy and silently drop ~14/15 of data.
        raise RuntimeError(
            "midi_syn='epr' requires virtuosoNet: pass epr_generate("
            "xml_path, composer) -> midi_path, or set midi_syn='score'")
    if midi_syn == "score" and not have_tool("verovio"):
        raise RuntimeError("verovio not found on PATH (needed for "
                           "score-MIDI rendering)")
    from ..symbolic.midi_io import MIDIProcess
    rng = np.random.RandomState(seed)
    if midi_syn == "epr":
        for v in range(1, 4):
            for split in ("valid", "test"):
                src = os.path.join(feature_folder, split, "0")
                dst = os.path.join(feature_folder, split, str(v))
                if os.path.isdir(src) and not os.path.isdir(dst):
                    shutil.copytree(src, dst)

    for split in ("train", "test", "valid"):
        for v in versions:
            if split != "train":
                if midi_syn == "epr" and v >= 4:
                    continue
                if midi_syn == "score" and v > 0:
                    continue
            folder = os.path.join(feature_folder, split, str(v))
            target_dir = os.path.join(folder, "target")
            if not os.path.isdir(target_dir):
                continue
            _mkdirs(os.path.join(folder, "midi"))
            for target_file in sorted(os.listdir(target_dir)):
                name = target_file[:-4]
                xml_path = os.path.join(folder, "xml", f"{name}.xml")
                midi_path = os.path.join(folder, "midi", f"{name}.mid")
                info_path = os.path.join(folder, "info", f"{name}.json")
                if not os.path.exists(xml_path):
                    continue
                if split == "train":
                    composer = (rng.choice(TRAIN_COMPOSERS)
                                if midi_syn == "epr" else "score")
                else:
                    composer = (TEST_COMPOSERS[int(v)]
                                if midi_syn == "epr" else "score")
                try:
                    if composer == "score" and (have_tool("verovio")
                                                or epr_generate is None):
                        tmp_mid = midi_path + ".raw.mid"
                        r = subprocess.run(
                            ["verovio", "-f", "musicxml-hum", "-t", "midi",
                             xml_path, "-o", tmp_mid], capture_output=True,
                            text=True)
                        # The reference also drops chunks verovio renders
                        # WITH warnings/errors on stderr — exit 0 with a
                        # warning means partially rendered content
                        # (reference: render.py:430-436).
                        if r.returncode != 0 or (
                                r.stderr and ("Warning" in r.stderr
                                              or "Error" in r.stderr)):
                            continue
                        src_mid = tmp_mid
                    elif composer == "score" and getattr(
                            epr_generate, "handles_score", False):
                        # No verovio on this host: the native EPR engine's
                        # deadpan 'score' style renders exact notated
                        # timing — these chunks would otherwise be
                        # silently dropped by the skip-and-continue
                        # policy (~1/15 of train + all v=0 eval sets).
                        # (virtuosoNet generators don't handle 'score';
                        # with one of those and no verovio, the chunk is
                        # dropped exactly as in the reference.)
                        src_mid = epr_generate(xml_path, "score")
                    elif composer == "score":
                        continue  # no verovio, generator can't cover it
                    else:
                        if epr_generate is None:
                            raise RuntimeError(
                                "midi_syn='epr' needs virtuosoNet; pass "
                                "epr_generate")
                        src_mid = epr_generate(xml_path, composer)
                    proc = MIDIProcess(src_mid, split, rng=rng)
                    scaling, original = proc.process(midi_path)
                    if os.path.exists(midi_path + ".raw.mid"):
                        os.remove(midi_path + ".raw.mid")
                    if scaling is not None and os.path.exists(info_path):
                        with open(info_path) as f:
                            info = json.load(f)
                        info.update({"composer": composer,
                                     "scaling": scaling,
                                     "original_length": original})
                        with open(info_path, "w") as f:
                            json.dump(info, f, indent=2)
                except BaseException as exc:
                    if not isinstance(exc, Exception):  # interrupts
                        raise
                    continue


# ---------------------------------------------------------------------------
# Stage 5: validity filtering
# ---------------------------------------------------------------------------

def clean_files(versions: Sequence[int], feature_folder: str) -> int:
    """Drop clips > 12 s or with pitches outside the piano range 21..108,
    or invalid key/time signatures (reference: render.py:514-562)."""
    from ..symbolic.midi_io import read_midi
    time_sig_list = load_time_signatures()
    deleted = 0
    for split in ("train", "valid", "test"):
        for v in versions:
            folder = os.path.join(feature_folder, split, str(v))
            midi_dir = os.path.join(folder, "midi")
            if not os.path.isdir(midi_dir):
                continue
            for midi_file in sorted(os.listdir(midi_dir)):
                name = midi_file[:-4]
                midi_path = os.path.join(midi_dir, midi_file)
                target_path = os.path.join(folder, "target", f"{name}.pkl")
                if not os.path.exists(target_path):
                    os.remove(midi_path)
                    deleted += 1
                    continue
                try:
                    midi = read_midi(midi_path)
                    notes = midi.notes()
                    duration = max((off for _, off, _, _ in notes),
                                   default=0.0)
                except BaseException as exc:
                    if not isinstance(exc, Exception):  # interrupts
                        raise
                    duration = 13.0
                    notes = []
                bad = duration > 12 or any(
                    p < 21 or p > 108 for _, _, p, _ in notes)
                if not bad:
                    with open(target_path, "rb") as f:
                        target = pickle.load(f)
                    for measure in target:
                        if measure[0] < -6 or measure[0] > 7 \
                                or measure[1] not in time_sig_list:
                            bad = True
                            break
                if bad:
                    os.remove(midi_path)
                    if os.path.exists(target_path):
                        os.remove(target_path)
                    deleted += 1
    return deleted


# ---------------------------------------------------------------------------
# Stage 6: audio synthesis (FluidSynth) + loudness normalization
# ---------------------------------------------------------------------------

def render_one_midi(midi_path: str, wav_path: str, soundfont_path: str,
                    sample_rate: int = 44100) -> bool:
    """FluidSynth synthesis + the reference's compressor/loudness loop
    (reference: render.py:321-385)."""
    from ..utils.audio import read_wav, write_wav
    r = subprocess.run(
        ["fluidsynth", "-ni", soundfont_path, midi_path, "-F", wav_path,
         "-r", str(sample_rate)], capture_output=True)
    if r.returncode != 0 or not os.path.exists(wav_path):
        return False
    data, rate = read_wav(wav_path)
    out, _ = normalize_rendered_audio(
        data, rate, Compressor(threshold_db=-1, ratio=18, attack_ms=50))
    write_wav(wav_path, out, rate)
    return True


def render_all_midi(versions: Sequence[int], feature_folder: str,
                    soundfont_folder: str, seed: int = 0) -> None:
    """(reference: render.py:274-319)"""
    if not have_tool("fluidsynth"):
        raise RuntimeError("fluidsynth not found on PATH")
    rng = np.random.RandomState(seed)
    for split in ("train", "valid"):
        for v in versions:
            folder = os.path.join(feature_folder, split, str(v))
            midi_dir = os.path.join(folder, "midi")
            if not os.path.isdir(midi_dir):
                continue
            _mkdirs(os.path.join(folder, "wav"))
            for midi_file in sorted(os.listdir(midi_dir)):
                fonts = (TRAIN_SOUNDFONTS if split == "train"
                         else TEST_SOUNDFONTS)
                soundfont = fonts[rng.randint(len(fonts))]
                wav_path = os.path.join(
                    folder, "wav",
                    midi_file[:-4] + f"~{soundfont[:-4]}.wav")
                render_one_midi(os.path.join(midi_dir, midi_file), wav_path,
                                os.path.join(soundfont_folder, soundfont))
    for v in versions:
        folder = os.path.join(feature_folder, "test", str(v))
        midi_dir = os.path.join(folder, "midi")
        if not os.path.isdir(midi_dir):
            continue
        _mkdirs(os.path.join(folder, "wav"))
        for midi_file in sorted(os.listdir(midi_dir)):
            for soundfont in TEST_SOUNDFONTS:
                wav_path = os.path.join(
                    folder, "wav",
                    midi_file[:-4] + f"~{soundfont[:-4]}.wav")
                render_one_midi(os.path.join(midi_dir, midi_file), wav_path,
                                os.path.join(soundfont_folder, soundfont))


# ---------------------------------------------------------------------------
# Stage 7: spectrograms
# ---------------------------------------------------------------------------

def write_features(wav_path: str, spec_path: str, audio_path: str,
                   cfg: VQTConfig, max_duration: float) -> bool:
    """One clip of a feature pass: the WAV resampled to cfg.sample_rate,
    written as int16 PCM to ``audio_path`` and as its log-VQT to
    ``spec_path``, each unless it exists. A clip longer than
    ``max_duration`` seconds is skipped. Returns whether a spectrogram was
    written."""
    data, sr = read_wav(wav_path)
    if len(data) / sr > max_duration:
        return False
    data = resample(data, sr, cfg.sample_rate)
    if not os.path.exists(audio_path):
        np.save(audio_path, to_pcm16(data))
    if os.path.exists(spec_path):
        return False
    np.save(spec_path, get_vqt_host(data, cfg))
    return True


def prepare_spectrograms(versions: Sequence[int], feature_folder: str,
                         sample_rate: int = 16000,
                         max_duration: float = 12.0) -> int:
    """WAV -> log-VQT .npy (reference: render.py:491-512) for every
    {train,valid,test}/{version}/wav/ folder under ``feature_folder``.
    Also emits audio/ .npy (model-rate int16 PCM), the layout the
    `input_features: audio` (on-device VQT) training mode reads. A clip
    longer than ``max_duration`` seconds is skipped; files already present
    are left alone. Returns the number of spectrograms written."""
    cfg = VQTConfig(sample_rate=sample_rate)
    n = 0
    for split in ("train", "valid", "test"):
        for v in versions:
            folder = os.path.join(feature_folder, split, str(v))
            wav_dir = os.path.join(folder, "wav")
            if not os.path.isdir(wav_dir):
                continue
            spec_dir = os.path.join(folder, "spectrogram")
            audio_dir = os.path.join(folder, "audio")
            os.makedirs(spec_dir, exist_ok=True)
            os.makedirs(audio_dir, exist_ok=True)
            for wav_file in sorted(os.listdir(wav_dir)):
                spec_path = os.path.join(spec_dir, wav_file[:-4] + ".npy")
                audio_path = os.path.join(audio_dir, wav_file[:-4] + ".npy")
                if os.path.exists(spec_path) and os.path.exists(audio_path):
                    continue
                n += write_features(os.path.join(wav_dir, wav_file),
                                    spec_path, audio_path, cfg, max_duration)
    return n
