"""ASAP real-recording preprocessing.

A copy of piano_a2s_tpu/data/asap.py for the port: for the same ASAP
checkout (and the same verovio on PATH) it writes the same files. Its
feature pass is ``prepare_spectrograms``, a function of the three values it
reads, which ``ProcessASAP.prepare_spectrograms`` calls.

Port of the reference's ProcessASAP (reference: datasets/asap.py:21-274)
with a native redesign: instead of slicing the score with music21 and
round-tripping every 5-bar chunk through verovio, the full score is
converted to kern ONCE (verovio) and chunked with our Kern.split(5,
stride=1); spine extraction / tie repair use the native kern tools. Audio
slicing, beat-annotation parsing, and target building are pure host code.

Outputs are identical in layout: {feature_folder}/{split}/{wav,kern,
kern_upper,kern_lower,target,info,spectrogram,audio}.
"""

from __future__ import annotations

import os
import pickle
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from ..symbolic.humdrum import (Kern, count_measure_segments,
                                process_voices, sort_chords, sort_voices)
from ..symbolic.native import extract_spine, tiefix_kern
from ..ops.vqt import VQTConfig
from ..symbolic.vocab import LabelsMultiple
from .datasets import load_split_list, load_time_signatures
from .render import write_features


def drop_opening_barline(kern: "Kern") -> "Kern":
    """Remove an opening barline that precedes ANY content (e.g. the
    invisible '=1-' verovio emits for some scores): Kern.split would
    count an empty leading measure and every chunk would sit one measure
    behind its downbeat audio window — silently, because the
    content-based measure-count guard still matches."""
    body = list(kern.body)
    for idx, line in enumerate(body):
        if line.startswith(("!", "*")) or not line.strip():
            continue
        if line.split("\t")[0].startswith("="):
            body = body[:idx] + body[idx + 1:]
            return Kern(data="\n".join(kern.header + body + kern.footer))
        break
    return kern


def parse_annotation_downbeats(anno_lines: List[str]
                               ) -> Tuple[bool, List[Tuple[float,
                                                           Optional[str],
                                                           Optional[str]]]]:
    """ASAP performance annotations -> (has_upbeat, [(time, key, time_sig)])
    (reference: asap.py:223-251)."""
    first = anno_lines[0].split("\t")
    first_beat = first[2].split(",")
    upbeat = first_beat[0] == "b"
    key, time_sig = None, None
    if len(first_beat) == 2:
        time_sig = first_beat[1]
    elif len(first_beat) == 3:
        time_sig = first_beat[1] or time_sig
        key = first_beat[2] or key
    downbeats = [(0.0, key, time_sig)]
    for line in anno_lines:
        parts = line.split("\t")
        time = float(parts[0])
        beat = parts[2].split(",")
        beat_type = beat[0]
        if len(beat) >= 2:
            time_sig = beat[1] or time_sig
        if len(beat) >= 3:
            key = beat[2] or key
        if beat_type == "db":
            downbeats.append((time, key, time_sig))
    return upbeat, downbeats


class ProcessASAP:
    def __init__(self, asap_folder: str, feature_folder: str,
                 sample_rate: int = 16000, max_duration: float = 12.0):
        self.asap_folder = asap_folder
        self.feature_folder = feature_folder
        self.sample_rate = sample_rate
        self.max_duration = max_duration
        self.labels = LabelsMultiple(extended=True)
        self.time_sig_list = load_time_signatures()
        self.train_songs = set(load_split_list("train_asap.txt")[1:])
        self.test_songs = set(load_split_list("test_asap.txt")[1:])
        self.folders = self._get_smallest_subdirectories()

    # -- directory walking ---------------------------------------------------

    def _get_smallest_subdirectories(self) -> List[str]:
        out: List[str] = []

        def walk(path: str) -> None:
            subdirs = [d for d in sorted(os.listdir(path))
                       if os.path.isdir(os.path.join(path, d))]
            if not subdirs and os.path.exists(
                    os.path.join(path, "xml_score.musicxml")):
                out.append(path)
            else:
                for d in subdirs:
                    walk(os.path.join(path, d))

        if os.path.isdir(self.asap_folder):
            walk(self.asap_folder)
        return out

    def _score_name(self, folder: str) -> str:
        parts = folder.split(os.sep)
        for anchor in ("asap-dataset-master", "asap-dataset"):
            if anchor in parts:
                return "#".join(parts[parts.index(anchor) + 1:])
        return "#".join(parts[-3:])

    # -- main ------------------------------------------------------------------

    def process_all(self) -> List[str]:
        for split in ("train", "test"):
            for sub in ("wav", "midi", "xml", "kern", "target",
                        "kern_upper", "kern_lower", "info"):
                os.makedirs(os.path.join(self.feature_folder, split, sub),
                            exist_ok=True)
        unmatched: List[str] = []
        for folder in self.folders:
            unmatched.extend(self.process_one(folder))
        with open(os.path.join(self.feature_folder, "unmatched.txt"),
                  "w") as f:
            f.writelines(u + "\n" for u in unmatched)
        self.prepare_spectrograms()
        return unmatched

    def _score_to_kern_chunks(self, folder: str):
        """Full score -> kern -> RAW 5-bar chunks (stride 1).

        Chunks are cleaned individually in _process_chunk so a single
        ornament somewhere in the score only discards ITS chunks, matching
        the reference's per-chunk cleaning (asap.py:126-133)."""
        xml_path = os.path.join(folder, "xml_score.musicxml")
        kern_path = os.path.join(folder, "xml_score.converted.krn")
        r = subprocess.run(
            ["verovio", "-f", "musicxml-hum", "-t", "hum", xml_path,
             "-o", kern_path], capture_output=True, text=True)
        # Errors abort the score; WARNINGS are tolerated (journaled) —
        # the reference converts per chunk and drops only warned chunks
        # (asap.py:114-120), so rejecting the whole score on one warning
        # in a single conversion would lose every chunk of a long score.
        # Bad content still gets caught per chunk by the cleanliness and
        # measure-alignment guards below.
        if r.returncode != 0 or "Error" in (r.stderr or ""):
            return None, 0
        if "Warning" in (r.stderr or ""):
            print(f"{xml_path}: verovio warned (continuing): "
                  f"{(r.stderr or '').strip()[:200]}")
        with open(kern_path, encoding="iso-8859-1") as f:
            text = f.read()
        full = drop_opening_barline(Kern(data=text))
        n_measures = count_measure_segments("\n".join(full.body))
        try:
            chunks = full.split(5, 1)
        except BaseException as exc:
            if not isinstance(exc, Exception):  # interrupts
                raise
            return None, n_measures
        return chunks, n_measures

    def process_one(self, folder: str) -> List[str]:
        from ..utils.audio import read_wav
        score_name = self._score_name(folder)
        if score_name in self.train_songs:
            split = "train"
        elif score_name in self.test_songs:
            split = "test"
        else:
            return []
        chunks, n_measure_score = self._score_to_kern_chunks(folder)
        if chunks is None:
            return []
        feature_folder = os.path.join(self.feature_folder, split)
        performances = sorted(f[:-4] for f in os.listdir(folder)
                              if f.endswith(".wav"))
        unmatched: List[str] = []
        for performance in performances:
            anno_path = os.path.join(folder,
                                     f"{performance}_annotations.txt")
            if not os.path.exists(anno_path):
                continue
            with open(anno_path) as f:
                anno = [line.strip() for line in f if line.strip()]
            upbeat, downbeats = parse_annotation_downbeats(anno)
            n_anno = len(downbeats) if upbeat else len(downbeats) - 1
            if n_measure_score != n_anno:
                unmatched.append("#".join([score_name, performance]))
                continue
            audio, sr = read_wav(os.path.join(folder,
                                              f"{performance}.wav"))
            peak = np.max(np.abs(audio))
            if peak > 0:
                audio = audio / peak
            # Annotation index i refers to real measures i+1..i+5. With an
            # upbeat, kern chunk 0 starts at the PICKUP, so the chunk for
            # annotation i is chunks[i+1] (the reference slices
            # m21.measures(i+1, i+5), excluding the pickup).
            offset = 1 if upbeat else 0
            for i in range(len(chunks) - offset):
                if upbeat and i == 0:
                    continue  # reference skips the first upbeat window
                self._process_chunk(chunks[i + offset], i, audio, sr,
                                    downbeats, score_name, performance,
                                    feature_folder, split)
        return unmatched

    def _process_chunk(self, chunk: Kern, i: int, audio, sr, downbeats,
                       score_name: str, performance: str,
                       feature_folder: str, split: str) -> bool:
        name = f"{score_name}#{performance}.{i}"
        try:
            start = int(downbeats[i + 1][0] * sr)
            end = int(downbeats[i + 6][0] * sr)
        except IndexError:
            return False
        chunk_audio = audio[start:end]
        if len(chunk_audio) > 12 * sr or len(chunk_audio) < 4 * sr:
            return False

        # Per-chunk cleaning (reference semantics: a chunk whose own five
        # measures needed cleaning is skipped; other chunks survive).
        text = chunk.dump()
        try:
            lower = Kern(data=extract_spine(text, 1))
            upper = Kern(data=extract_spine(text, 2))
        except ValueError:
            return False  # unsupported *+/*x manipulators: skip chunk
        full = Kern(data=text)
        for kern in (lower, upper, full):
            ok, cleaned = kern.clean()
            if not ok or cleaned:
                return False
        fixed_by_sub = {}
        for kern, sub in ((lower, "kern_lower"), (upper, "kern_upper"),
                          (full, "kern")):
            try:
                fixed_by_sub[sub] = tiefix_kern(kern.dump())
            except ValueError:
                return False
            with open(os.path.join(feature_folder, sub, f"{name}.krn"),
                      "w", encoding="iso-8859-1") as f:
                f.write(fixed_by_sub[sub])
        lower = Kern(data=fixed_by_sub["kern_lower"])
        upper = Kern(data=fixed_by_sub["kern_upper"])

        try:
            lower = process_voices(lower)
            upper = process_voices(upper)
        except BaseException as exc:
            if not isinstance(exc, Exception):  # interrupts
                raise
            return False
        if lower is False or upper is False:
            return False
        try:
            lower = sort_voices(sort_chords(lower))
            upper = sort_voices(sort_chords(upper))
        except BaseException as exc:
            if not isinstance(exc, Exception):  # interrupts
                raise
            return False
        if lower is False or upper is False:
            return False
        lower_seq = lower.tosequence()
        upper_seq = upper.tosequence()
        if lower_seq is None or upper_seq is None:
            return False

        from ..symbolic.export import split_sequence_bars
        lower_bars = split_sequence_bars(lower_seq)
        upper_bars = split_sequence_bars(upper_seq)
        if len(lower_bars) < 5 or len(upper_bars) < 5:
            return False
        target = []
        for m in range(5):
            try:
                key = int(downbeats[i + 1 + m][1])
                time = downbeats[i + 1 + m][2]
            except (TypeError, ValueError):
                return False
            if time not in self.time_sig_list:
                return False
            try:
                target.append([key, time, self.labels.encode(lower_bars[m]),
                               self.labels.encode(upper_bars[m])])
            except BaseException as exc:
                if not isinstance(exc, Exception):  # interrupts
                    raise
                return False
        from ..utils.audio import write_wav
        write_wav(os.path.join(feature_folder, "wav", f"{name}.wav"),
                  chunk_audio, sr)
        with open(os.path.join(feature_folder, "target", f"{name}.pkl"),
                  "wb") as f:
            pickle.dump(target, f)
        return True

    def prepare_spectrograms(self) -> int:
        """The feature pass over this feature folder (module function
        ``prepare_spectrograms``)."""
        return prepare_spectrograms(self.feature_folder, self.sample_rate,
                                    self.max_duration)


def prepare_spectrograms(feature_folder: str, sample_rate: int = 16000,
                         max_duration: float = 12.0) -> int:
    """WAV -> log-VQT spectrogram/ .npy for every clip of
    {train,test}/target/ whose {split}/wav/{name}.wav exists; also emits
    audio/ .npy (model-rate int16 PCM) so the `input_features: audio`
    (on-device VQT) finetuning mode has its layout without a separate
    pass. A clip longer than ``max_duration`` seconds is skipped; files
    already present are left alone. Returns the number of spectrograms
    written."""
    cfg = VQTConfig(sample_rate=sample_rate)
    n = 0
    for split in ("train", "test"):
        folder = os.path.join(feature_folder, split)
        target_dir = os.path.join(folder, "target")
        if not os.path.isdir(target_dir):
            continue
        spec_dir = os.path.join(folder, "spectrogram")
        audio_dir = os.path.join(folder, "audio")
        os.makedirs(spec_dir, exist_ok=True)
        os.makedirs(audio_dir, exist_ok=True)
        for target_file in sorted(os.listdir(target_dir)):
            name = target_file[:-4]
            wav_path = os.path.join(folder, "wav", f"{name}.wav")
            spec_path = os.path.join(spec_dir, f"{name}.npy")
            audio_path = os.path.join(audio_dir, f"{name}.npy")
            if (os.path.exists(spec_path)
                    and os.path.exists(audio_path)) or \
                    not os.path.exists(wav_path):
                continue
            n += write_features(wav_path, spec_path, audio_path, cfg,
                                max_duration)
    return n
