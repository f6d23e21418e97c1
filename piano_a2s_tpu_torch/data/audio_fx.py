"""Offline audio DSP for the synthesis pipeline: ITU-R BS.1770 loudness
measurement/normalization and a dynamic-range compressor.

A copy of piano_a2s_tpu/data/audio_fx.py for the port: for the same
samples it returns the same arrays.

Replaces the reference's pyloudnorm + pedalboard dependencies
(reference: data_processing/render.py:282,321-385). The loudness meter
implements BS.1770-4 (K-weighting + gated integrated loudness, the same
algorithm as pyloudnorm); the compressor is a feed-forward block-envelope
design with pedalboard-compatible parameters (threshold_db, ratio,
attack_ms) — an offline augmentation effect, not a bit-exact JUCE port.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy import signal


# ---------------------------------------------------------------------------
# BS.1770 loudness
# ---------------------------------------------------------------------------

def _rbj_high_shelf(fs: float, f0: float, gain_db: float, q: float):
    a = 10 ** (gain_db / 40)
    w0 = 2 * math.pi * f0 / fs
    alpha = math.sin(w0) / (2 * q)
    cosw = math.cos(w0)
    b0 = a * ((a + 1) + (a - 1) * cosw + 2 * math.sqrt(a) * alpha)
    b1 = -2 * a * ((a - 1) + (a + 1) * cosw)
    b2 = a * ((a + 1) + (a - 1) * cosw - 2 * math.sqrt(a) * alpha)
    a0 = (a + 1) - (a - 1) * cosw + 2 * math.sqrt(a) * alpha
    a1 = 2 * ((a - 1) - (a + 1) * cosw)
    a2 = (a + 1) - (a - 1) * cosw - 2 * math.sqrt(a) * alpha
    return np.array([b0, b1, b2]) / a0, np.array([1, a1 / a0, a2 / a0])


def _rbj_highpass(fs: float, f0: float, q: float):
    w0 = 2 * math.pi * f0 / fs
    alpha = math.sin(w0) / (2 * q)
    cosw = math.cos(w0)
    b = np.array([(1 + cosw) / 2, -(1 + cosw), (1 + cosw) / 2])
    a = np.array([1 + alpha, -2 * cosw, 1 - alpha])
    return b / a[0], a / a[0]


def k_weight(data: np.ndarray, fs: float) -> np.ndarray:
    """Apply the BS.1770 K-weighting pre-filter chain."""
    b1, a1 = _rbj_high_shelf(fs, 1681.9744509555319, 3.99984385397, 0.7071752369554193)
    b2, a2 = _rbj_highpass(fs, 38.13547087613982, 0.5003270373253953)
    return signal.lfilter(b2, a2, signal.lfilter(b1, a1, data))


def integrated_loudness(data: np.ndarray, fs: float) -> float:
    """Gated integrated loudness (LUFS) of mono audio."""
    data = np.asarray(data, np.float64)
    if data.ndim > 1:
        data = data.mean(axis=1)
    y = k_weight(data, fs)
    block = int(0.400 * fs)
    hop = int(0.100 * fs)  # 75% overlap
    if len(y) < block:
        return -np.inf
    n_blocks = 1 + (len(y) - block) // hop
    idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
    z = np.mean(y[idx] ** 2, axis=1)
    with np.errstate(divide="ignore"):
        lk = -0.691 + 10 * np.log10(z)
    above_abs = z[lk > -70.0]
    if len(above_abs) == 0:
        return -np.inf
    gamma_r = -0.691 + 10 * np.log10(above_abs.mean()) - 10.0
    gated = z[(lk > -70.0) & (lk > gamma_r)]
    if len(gated) == 0:
        return -np.inf
    return float(-0.691 + 10 * np.log10(gated.mean()))


def peak_normalize(data: np.ndarray, target_db: float = -1.0) -> np.ndarray:
    peak = np.max(np.abs(data))
    if peak == 0:
        return data
    gain = 10 ** ((target_db - 20 * np.log10(peak)) / 20)
    return data * gain


def loudness_normalize(data: np.ndarray, current_lufs: float,
                       target_lufs: float) -> np.ndarray:
    if not np.isfinite(current_lufs):
        return data
    return data * 10 ** ((target_lufs - current_lufs) / 20)


# ---------------------------------------------------------------------------
# Compressor
# ---------------------------------------------------------------------------

class Compressor:
    """Feed-forward compressor with pedalboard-compatible parameters."""

    def __init__(self, threshold_db: float = 0.0, ratio: float = 1.0,
                 attack_ms: float = 1.0, release_ms: float = 100.0):
        self.threshold_db = threshold_db
        self.ratio = ratio
        self.attack_ms = attack_ms
        self.release_ms = release_ms

    def __call__(self, data: np.ndarray, fs: float) -> np.ndarray:
        data = np.asarray(data, np.float64)
        hop = max(int(fs) // 1000, 1)  # ~1 ms envelope blocks
        n_blocks = int(np.ceil(len(data) / hop))
        padded = np.pad(data, (0, n_blocks * hop - len(data)))
        peaks = np.abs(padded.reshape(n_blocks, hop)).max(axis=1)
        with np.errstate(divide="ignore"):
            level_db = 20 * np.log10(np.maximum(peaks, 1e-10))
        over = np.maximum(level_db - self.threshold_db, 0.0)
        target_gr = over * (1.0 - 1.0 / max(self.ratio, 1.0))
        # Smooth gain reduction: attack when rising, release when falling.
        atk = math.exp(-hop / (max(self.attack_ms, 0.01) * fs / 1000))
        rel = math.exp(-hop / (max(self.release_ms, 0.01) * fs / 1000))
        gr = np.empty_like(target_gr)
        state = 0.0
        for i, tgt in enumerate(target_gr):
            coeff = atk if tgt > state else rel
            state = coeff * state + (1 - coeff) * tgt
            gr[i] = state
        gains = 10 ** (-gr / 20)
        gain_per_sample = np.repeat(gains, hop)[: len(data)]
        return (data * gain_per_sample).astype(np.float64)


def normalize_rendered_audio(data: np.ndarray, rate: float,
                             compressor: "Compressor | None" = None
                             ) -> Tuple[np.ndarray, float]:
    """The reference's two-stage loudness normalization feedback loop
    (reference: render.py:326-378): compress until integrated loudness
    reaches -20 LUFS, then normalize to -15 LUFS keeping peaks under 0.9,
    then peak-normalize to -1 dBFS. Returns (audio, final LUFS)."""
    comp = compressor or Compressor(threshold_db=-1, ratio=18, attack_ms=50)
    if data.ndim > 1:
        data = data.mean(axis=1)

    data_copy = peak_normalize(data, -1.0)
    attempt = 0
    while integrated_loudness(data_copy, rate) < -20:
        normalized = peak_normalize(data, -1.0)
        threshold = integrated_loudness(normalized, rate) + 15
        if attempt % 3 == 2:
            comp.threshold_db -= 1
            if comp.threshold_db < threshold:
                break
        elif attempt % 3 == 1:
            comp.attack_ms *= 0.7
            if comp.attack_ms < 3:
                break
        else:
            comp.ratio += 2
            if comp.ratio > 34:
                break
        data_copy = peak_normalize(comp(normalized, rate), -1.0)
        attempt += 1

    comp.threshold_db, comp.attack_ms, comp.ratio = -5, 10, 1
    attempt = 0
    data = data_copy
    data_copy = loudness_normalize(data, integrated_loudness(data, rate),
                                   -15)
    while data_copy.max() > 0.9 or data_copy.min() < -0.9:
        data_copy = loudness_normalize(data, integrated_loudness(data, rate),
                                       -15)
        if attempt % 3 == 2:
            comp.threshold_db -= 0.5
            if comp.threshold_db < -10:
                break
        elif attempt % 3 == 1:
            comp.attack_ms *= 0.75
            if comp.attack_ms < 1:
                break
        else:
            comp.ratio += 1.5
            if comp.ratio > 15:
                break
        data_copy = comp(data_copy, rate)
        attempt += 1

    out = peak_normalize(data_copy, -1.0)
    return out, integrated_loudness(out, rate)
