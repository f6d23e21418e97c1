"""Audio IO without external codec dependencies (numpy + scipy).

The part of piano_a2s_tpu/utils/audio.py that the port uses: WAV reading
(PCM 8/16/24/32) and 16-bit writing via the stdlib wave module, polyphase
resampling via
scipy, int16 conversions, and the fixed-length batch contract of the
Transcriber and the datasets.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np
from scipy import signal as _signal

# WAV 16-bit PCM decode scale: read_wav, read_wav_pcm16 and the on-device
# int16 conversion (Transcriber, the training audio frontend) all divide by
# this, so an int16 batch and its float32 twin give the same spectrogram.
PCM16_SCALE = 32768.0


def float32_to_int16(x: np.ndarray) -> np.ndarray:
    """float in [-1, 1] -> int16 at the reference's x 32767 scale (the
    reference's data-pipeline helper; not the inverse of PCM16_SCALE)."""
    assert np.max(np.abs(x)) <= 1.0
    return (x * 32767.0).astype(np.int16)


def int16_to_float32(x: np.ndarray) -> np.ndarray:
    """int16 -> float32 at the reference's / 32767 scale (the inverse of
    float32_to_int16)."""
    return (x / 32767.0).astype(np.float32)


def to_pcm16(data: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> int16 PCM with the scale the device conversion
    undoes exactly (PCM16_SCALE): the training batches' int16 staging."""
    return np.clip(np.round(np.asarray(data, np.float32) * PCM16_SCALE),
                   -32768, 32767).astype(np.int16)


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Read a WAV file (path or binary file-like, e.g. a BytesIO over an
    HTTP body) -> (mono float32 in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = (np.frombuffer(raw, dtype="<i2").astype(np.float32)
                / PCM16_SCALE)
    elif width == 4:
        # Could be PCM32 or float32; WAVE_FORMAT tag isn't exposed by the
        # wave module — assume PCM32 (float WAVs are rare from synths).
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2**31
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        data = ((b[:, 0].astype(np.int32))
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        data = (data << 8 >> 8).astype(np.float32) / 2**23
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return data, sr


def read_wav_pcm16(path: str, expect_sr=None):
    """(int16 mono samples, sample_rate) if the file is 16-bit PCM mono
    (and, when expect_sr is given, at that rate), else None.

    A 16-bit mono WAV at the model rate goes to the device as int16 (half
    the bytes) and is converted there with PCM16_SCALE, which makes the
    int16 path give the float path's values. The header is checked before
    the frames are read, so a rejected file costs only a header read."""
    with wave.open(path, "rb") as w:
        if w.getnchannels() != 1 or w.getsampwidth() != 2:
            return None
        sr = w.getframerate()
        if expect_sr is not None and sr != expect_sr:
            return None
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2"), sr


def write_wav(path: str, data: np.ndarray, sr: int) -> None:
    """Mono 16-bit PCM WAV of ``data`` clipped to [-1, 1], at the
    reference's x 32767 scale."""
    data = np.clip(np.asarray(data, np.float32), -1.0, 1.0)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((data * 32767.0).astype("<i2").tobytes())


def pcm16_to_float(data: np.ndarray) -> np.ndarray:
    """int16 PCM -> float32 with read_wav's exact scale; float passes
    through as float32."""
    data = np.asarray(data)
    if data.dtype == np.int16:
        return data.astype(np.float32) / PCM16_SCALE
    return data.astype(np.float32)


def trim_pad_audio(audio: np.ndarray, max_samples: int) -> np.ndarray:
    """Trim/zero-pad a mono clip to exactly max_samples, keeping int16
    (converted on the device) and normalizing other dtypes to float32."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = audio.astype(np.float32)
    audio = audio[:max_samples]
    if len(audio) < max_samples:
        audio = np.pad(audio, (0, max_samples - len(audio)))
    return audio


def stack_audio_batch(clips) -> np.ndarray:
    """Stack same-length mono clips into a batch. Mixed int16/float
    inputs are normalized to float32 first — a bare np.stack would
    promote raw int16 values into the float batch (wrong by 32768x,
    and silent)."""
    if any(c.dtype != clips[0].dtype for c in clips):
        clips = [pcm16_to_float(c) for c in clips]
    return np.stack(clips)


def resample(data: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return data
    from math import gcd
    g = gcd(sr_in, sr_out)
    return _signal.resample_poly(data, sr_out // g, sr_in // g).astype(
        np.float32)
