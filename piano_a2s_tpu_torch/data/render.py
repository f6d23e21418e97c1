"""Stage 7 of the synthesis pipeline: WAV -> spectrogram/ and audio/ .npy.

The port's copy of ``prepare_spectrograms`` from
piano_a2s_tpu/data/render.py, with the port's host VQT twin
(``ops.vqt.get_vqt_host``) and audio helpers: for the same WAV files it
writes the same .npy files. ``write_features``, its work on one clip, is
shared with the ASAP pass (``data/asap.py``). The stages before it
(convert, preprocess, split, midi, clean, render) run on the host with
external tools (verovio, FluidSynth, virtuosoNet) and stay with the JAX
package: run them with ``python prepare_data.py syn <yaml> <stage>``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..ops.vqt import VQTConfig, get_vqt_host
from ..utils.audio import read_wav, resample, to_pcm16


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
