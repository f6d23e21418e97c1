"""ASAP feature pass: WAV -> spectrogram/ and audio/ .npy.

The port's copy of ``ProcessASAP.prepare_spectrograms`` from
piano_a2s_tpu/data/asap.py, as a function of the three values it reads
(the feature folder, the sample rate, the longest clip): for the same WAV
files it writes the same .npy files. The stages before it (score
conversion with verovio, chunking, targets, the WAV slices) stay with the
JAX package: run them with ``python prepare_data.py asap <yaml>``.
"""

from __future__ import annotations

import os

from ..ops.vqt import VQTConfig
from .render import write_features


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
