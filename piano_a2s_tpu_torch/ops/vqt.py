"""Variable-Q transform (VQT) audio frontend (PyTorch).

Port of piano_a2s_tpu/ops/vqt.py. With gamma=20 every variable-Q filter
fits in one 1120-tap window, so the transform is a framed matmul of the
padded audio against a (1120, 480) cos and sin filterbank, then the
magnitude, then a per-clip log compression.

``vqt_magnitude`` dispatches on the audio's device: a CPU tensor takes the
plain PyTorch version (``vqt_magnitude_torch``), a CUDA tensor launches the
hand-written kernel (``ops.vqt_cuda``). There is no fallback between them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .vqt_cuda import vqt_magnitude_cuda


@dataclasses.dataclass(frozen=True)
class VQTConfig:
    sample_rate: int = 16000
    hop_length: int = 160
    fmin: float = 27.5  # A0
    bins_per_octave: int = 60
    n_octaves: int = 8
    gamma: float = 20.0
    filter_scale: float = 1.0
    # Covers the longest filter (~787 taps); a multiple of hop_length, which
    # the CUDA kernel requires.
    window_size: int = 1120

    @property
    def n_bins(self) -> int:
        return self.bins_per_octave * self.n_octaves


def _frequencies(cfg: VQTConfig) -> np.ndarray:
    return cfg.fmin * 2.0 ** (np.arange(cfg.n_bins) / cfg.bins_per_octave)


def filter_lengths(cfg: VQTConfig) -> np.ndarray:
    """Variable-Q filter lengths (samples)."""
    freqs = _frequencies(cfg)
    r = 2.0 ** (2.0 / cfg.bins_per_octave)
    alpha = (r - 1.0) / (r + 1.0)
    q = cfg.filter_scale / alpha
    return q * cfg.sample_rate / (freqs + cfg.gamma / alpha)


@functools.lru_cache(maxsize=8)
def build_kernels(cfg: VQTConfig = VQTConfig()) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """(cos, sin) filter matrices of shape (window_size, n_bins), float32.

    Each column is an L1-normalized hann-windowed complex exponential of its
    variable-Q length, centered in the window and scaled by sqrt(length).
    The arrays are cached per config and shared: do not write to them.
    """
    lengths = filter_lengths(cfg)
    freqs = _frequencies(cfg)
    w = cfg.window_size
    if lengths.max() > w:
        raise ValueError(
            f"window_size {w} shorter than max filter {lengths.max():.0f}")
    cos_k = np.zeros((w, cfg.n_bins), np.float64)
    sin_k = np.zeros((w, cfg.n_bins), np.float64)
    for k in range(cfg.n_bins):
        ilen = lengths[k]
        t = np.arange(-ilen // 2, ilen // 2)
        phase = 2.0 * math.pi * freqs[k] / cfg.sample_rate * t
        n = len(t)
        win = np.hanning(n + 2)[1:-1] if n > 1 else np.ones(1)
        sig_re = np.cos(phase) * win
        sig_im = np.sin(phase) * win
        l1 = np.sum(np.sqrt(sig_re ** 2 + sig_im ** 2))
        scale = math.sqrt(ilen) / l1
        start = (w - n) // 2
        cos_k[start:start + n, k] = sig_re * scale
        sin_k[start:start + n, k] = sig_im * scale
    return cos_k.astype(np.float32), sin_k.astype(np.float32)


def num_frames(n_samples: int, cfg: VQTConfig = VQTConfig()) -> int:
    return 1 + n_samples // cfg.hop_length


def filters(cfg: VQTConfig, device, dtype=torch.float32
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``build_kernels(cfg)`` as (cos, sin) tensors on ``device``."""
    return tuple(torch.tensor(k, dtype=dtype, device=device)
                 for k in build_kernels(cfg))


def vqt_magnitude_torch(y: torch.Tensor, kernels, cfg: VQTConfig = VQTConfig()
                        ) -> torch.Tensor:
    """Plain version: (..., L) audio -> (..., 1 + L // hop, n_bins).

    Pads window_size // 2 zeros on both sides and multiplies the frames
    (materialised by ``unfold``) with the filterbank, in y's dtype.
    """
    cos_k, sin_k = (k.to(y.dtype) for k in kernels)
    w = cfg.window_size
    y_pad = F.pad(y, (w // 2, w // 2))
    n = num_frames(y.shape[-1], cfg)
    frames = y_pad.unfold(-1, w, cfg.hop_length)[..., :n, :]
    re = frames @ cos_k
    im = frames @ sin_k
    return torch.sqrt(re * re + im * im)


def vqt_magnitude(y: torch.Tensor, kernels, cfg: VQTConfig = VQTConfig()
                  ) -> torch.Tensor:
    """(B, L) audio -> (B, n_frames, n_bins) VQT magnitude.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (which raises on inputs it does not take).
    """
    if y.device.type == "cpu":
        return vqt_magnitude_torch(y, kernels, cfg)
    cos_k, sin_k = kernels
    return vqt_magnitude_cuda(y, cos_k, sin_k, cfg.window_size,
                              cfg.hop_length)


def log_compress(mag: torch.Tensor, amin: float = 1e-5,
                 top_db: float = 80.0) -> torch.Tensor:
    """librosa amplitude_to_db(ref=max, top_db) / 80 + 1, output in [0, 1].

    For batched input (..., T, F) the max-reference is taken per clip (the
    last two axes), never over the batch.
    """
    power = torch.clamp(mag, min=amin) ** 2
    ref = torch.amax(power, dim=(-2, -1), keepdim=True)
    db = 10.0 * (torch.log10(power) - torch.log10(ref))
    db = torch.maximum(db, torch.amax(db, dim=(-2, -1), keepdim=True)
                       - top_db)
    return db / top_db + 1.0


def get_vqt(y: torch.Tensor, kernels: Optional[tuple] = None,
            cfg: VQTConfig = VQTConfig()) -> torch.Tensor:
    """Audio (B, L) -> log-VQT spectrogram (B, n_frames, n_bins)."""
    if kernels is None:
        kernels = filters(cfg, y.device)
    return log_compress(vqt_magnitude(y, kernels, cfg))
