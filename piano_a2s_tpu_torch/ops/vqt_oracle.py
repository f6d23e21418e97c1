"""Host-side oracle reimplementing librosa's multirate VQT algorithm.

A copy of piano_a2s_tpu/ops/vqt_oracle.py for the port: the synthetic
corpus (``data/synth.py``, ``frontend='oracle'``) writes its spectrograms
with it. ``ops/vqt.py`` does not import it.

The reference computes spectrograms with ``librosa.vqt`` (reference:
utilities.py:240-254). librosa is not installed in this image, so this
module re-creates its *algorithm* — the recursive early-downsampling
octave loop — from the published implementation (librosa 0.10,
librosa/core/constantq.py + librosa/filters.py), as an INDEPENDENT check
on the direct-form frontend in ops/vqt.py:

  * per-octave wavelet banks built at the octave's (decimated) sample
    rate, periodic ('fftbins') Hann windows, L1 normalization;
  * FFT-domain filtering: kernels scaled by ``ilen / n_fft``, spectrum
    truncated to the positive half, applied to centered signal frames;
  * octave recursion: after each octave, halve hop/sr and decimate the
    signal by 2 while the hop stays even (hop 160 supports 5 halvings,
    the last octaves run at sr/32), with librosa's ``scale=True``
     1/sqrt(ratio) energy compensation (resampling itself uses scipy's
    polyphase FIR in place of librosa's soxr backend);
  * final ``V / sqrt(lengths @ original sr)`` scaling (``scale=True``).

It therefore shares NO modeling decisions with ops/vqt.py (which computes
one full-rate framed matmul with symmetric Hann windows): agreement
between the two quantifies how close the direct-form frontend is to what
``librosa.vqt`` produces.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as _signal

from .vqt import VQTConfig, log_compress_host

# 3-dB bandwidth of a Hann window in FFT bins (librosa WINDOW_BANDWIDTHS).
_HANN_BANDWIDTH = 1.50018310546875


def _et_alpha(bins_per_octave: int) -> float:
    r = 2.0 ** (2.0 / bins_per_octave)
    return (r - 1.0) / (r + 1.0)


def wavelet_lengths(freqs: np.ndarray, sr: float, filter_scale: float,
                    gamma: float, alpha: float):
    """Filter lengths in samples + the bank's upper frequency cutoff
    (librosa filters.wavelet_lengths)."""
    q = filter_scale / alpha
    lengths = q * sr / (freqs + gamma / alpha)
    cutoff = np.max(freqs * (1 + 0.5 * _HANN_BANDWIDTH / q) + 0.5 * gamma)
    return lengths, cutoff


def _wavelet_bank(freqs: np.ndarray, sr: float, filter_scale: float,
                  gamma: float, alpha: float, hop: int):
    """Complex wavelet bank, center-padded to a pow-2 FFT size
    (librosa filters.wavelet with norm=1, pad_fft=True)."""
    lengths, _ = wavelet_lengths(freqs, sr, filter_scale, gamma, alpha)
    kernels = []
    for ilen, freq in zip(lengths, freqs):
        t = np.arange(-ilen // 2, ilen // 2)
        sig = np.exp(1j * 2.0 * np.pi * freq / sr * t)
        # librosa __float_window: periodic window of ceil(n), tail zeroed —
        # for integer-length arange the tail zeroing is a no-op.
        win = _signal.get_window("hann", len(t), fftbins=True)
        sig = sig * win
        sig /= np.sum(np.abs(sig))  # L1 norm
        kernels.append(sig)
    max_len = max(len(k) for k in kernels)
    # librosa order of operations matters for frame alignment: wavelet()
    # center-pads each kernel within pow2(max_len) (pad_fft=True), and
    # THEN __vqt_filter_fft's fft(basis, n=n_fft) zero-extends at the END
    # when the two-hop bound pushes n_fft beyond pow2(max_len). Centering
    # directly in n_fft would time-shift every filter by (n_fft - p2)/2.
    p2 = int(2.0 ** np.ceil(np.log2(max_len)))
    # librosa __vqt_filter_fft: the FFT must cover at least two hops.
    n_fft = max(p2, int(2.0 ** (1 + np.ceil(np.log2(hop)))))
    bank = np.zeros((len(kernels), n_fft), complex)
    for i, k in enumerate(kernels):
        start = (p2 - len(k)) // 2
        bank[i, start:start + len(k)] = k
    return bank, n_fft, lengths


def _octave_response(y: np.ndarray, n_fft: int, hop: int,
                     fft_basis: np.ndarray) -> np.ndarray:
    """(n_filters, n_frames) response: centered frames -> rfft ->
    positive-half product with the filter spectra
    (librosa __cqt_response, pad_mode='constant')."""
    y_pad = np.pad(y, n_fft // 2)
    n_frames = 1 + (len(y_pad) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = y_pad[idx]  # (n_frames, n_fft)
    spec = np.fft.fft(frames, axis=-1)[:, :n_fft // 2 + 1]
    return fft_basis @ spec.T


def _halve_rate(y: np.ndarray) -> np.ndarray:
    """Decimate by 2 with librosa's scale=True energy compensation.

    librosa uses soxr's 'HQ' resampler; scipy's polyphase FIR (Kaiser) is
    an equivalent-quality stand-in — the comparison test budgets for the
    passband difference.
    """
    out = _signal.resample_poly(y, 1, 2)
    return out / np.sqrt(0.5)  # scale=True: /= sqrt(target_sr/orig_sr)


def vqt_librosa_host(y: np.ndarray,
                     cfg: VQTConfig = VQTConfig()) -> np.ndarray:
    """Multirate VQT magnitude, (n_frames, n_bins), following
    ``librosa.vqt(..., scale=True, norm=1, window='hann')``."""
    y = np.asarray(y, np.float64)
    sr, hop = float(cfg.sample_rate), cfg.hop_length
    bpo, n_bins = cfg.bins_per_octave, cfg.n_bins
    n_octaves = cfg.n_octaves
    alpha = _et_alpha(bpo)
    freqs = cfg.fmin * 2.0 ** (np.arange(n_bins) / bpo)

    lengths_full, cutoff = wavelet_lengths(
        freqs, sr, cfg.filter_scale, cfg.gamma, alpha)
    if cutoff > sr / 2:
        raise ValueError("filter bank exceeds Nyquist")

    my_y, my_sr, my_hop = y, sr, hop
    responses = []
    for i in range(n_octaves):
        lo = n_bins - bpo * (i + 1)
        hi = n_bins - bpo * i
        bank, n_fft, _ = _wavelet_bank(
            freqs[lo:hi], my_sr, cfg.filter_scale, cfg.gamma, alpha, my_hop)
        # librosa __vqt_filter_fft: scale kernels by ilen/n_fft, keep the
        # positive-frequency half of their spectra.
        lens_oct, _ = wavelet_lengths(
            freqs[lo:hi], my_sr, cfg.filter_scale, cfg.gamma, alpha)
        bank = bank * (lens_oct[:, None] / float(n_fft))
        fft_basis = np.fft.fft(bank, axis=-1)[:, :n_fft // 2 + 1]
        fft_basis *= np.sqrt(sr / my_sr)  # downsampling compensation
        responses.append(_octave_response(my_y, n_fft, my_hop, fft_basis))
        if my_hop % 2 == 0:
            my_hop //= 2
            my_sr /= 2.0
            my_y = _halve_rate(my_y)

    # __trim_stack: align every octave to the shortest frame count,
    # bottom octave first in the output bin order.
    n_frames = min(r.shape[1] for r in responses)
    v = np.empty((n_bins, n_frames), complex)
    for i, resp in enumerate(responses):
        lo = n_bins - bpo * (i + 1)
        v[lo:lo + bpo] = resp[:, :n_frames]

    v /= np.sqrt(lengths_full[:, None])  # scale=True
    return np.abs(v).T.astype(np.float64)


def get_vqt_librosa_host(y: np.ndarray, cfg: VQTConfig = VQTConfig(),
                         amin: float = 1e-5,
                         top_db: float = 80.0) -> np.ndarray:
    """Oracle counterpart of ops.vqt.get_vqt_host: log-compressed
    ``db/80 + 1`` spectrogram in [0, 1] (reference: utilities.py:253)."""
    return log_compress_host(vqt_librosa_host(y, cfg), amin, top_db)
