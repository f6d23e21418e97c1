"""Launch wrapper of the hand-written VQT magnitude kernel (csrc/vqt_mag.cu).

The kernel replaces the JAX package's Pallas kernel
(piano_a2s_tpu/ops/vqt_pallas.py::_vqt_kernel). It runs the framed
filterbank product on the TF32 tensor cores with float32 accuracy: each
operand is split into a TF32 ``hi`` part and a TF32 ``lo`` remainder, and
the kernel sums hi*hi + hi*lo + lo*hi in float32. The filters are split and
packed here, once per filter pair, in plain torch ops (``pack_filters``);
the audio is split on the card by the kernel's pre-pass.

It takes CUDA tensors only; the plain PyTorch version is
``ops.vqt.vqt_magnitude_torch``, and ``ops.vqt.vqt_magnitude`` picks between
the two by the tensor's device.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from . import _build

KC = 32  # taps per pipeline chunk (128 B of f32); must divide hop_length
TILE_COLS = 160  # packed filter columns per block: 80 bins x {cos, sin}

_packed_cache = WeakTensorKeyDictionary()
_packed_lock = threading.Lock()  # server worker threads share the cache


def _library():
    """The built kernel library, with its C signatures declared."""
    lib = _build.load("vqt_mag")
    lib.vqt_mag_launch.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.vqt_mag_launch.restype = ctypes.c_int
    lib.vqt_mag_tile_cols.argtypes = []
    lib.vqt_mag_tile_cols.restype = ctypes.c_int
    if lib.vqt_mag_tile_cols() != TILE_COLS:
        raise RuntimeError("csrc/vqt_mag.cu and ops/vqt_cuda.py disagree on "
                           "the tile width")
    return lib


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32
    with the low 13 mantissa bits zero: PTX ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo), both TF32 values, with hi + lo = x within 2^-22 |x|."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def pack_filters(cos_k: torch.Tensor, sin_k: torch.Tensor) -> torch.Tensor:
    """(W, n_bins) cos and sin filters -> (2, n_cols, W) float32.

    [0] is the hi part and [1] the lo part (``split_tf32``). Row 2f holds
    the cos filter of bin f and row 2f+1 its sin filter, K-major (taps
    contiguous); rows past 2 * n_bins are zero up to a multiple of
    TILE_COLS.
    """
    window, n_bins = cos_k.shape
    n_cols = -(-2 * n_bins // TILE_COLS) * TILE_COLS
    inter = torch.zeros((n_cols, window), dtype=torch.float32,
                        device=cos_k.device)
    inter[0:2 * n_bins:2] = cos_k.T
    inter[1:2 * n_bins:2] = sin_k.T
    return torch.stack(split_tf32(inter))


def _packed(cos_k: torch.Tensor, sin_k: torch.Tensor) -> torch.Tensor:
    """``pack_filters`` of this filter pair, computed once and kept while
    cos_k lives (and neither tensor was written in place). Filters made
    under ``torch.inference_mode`` have no version counter to tell a write,
    so such a pair is packed on every call."""
    if cos_k.is_inference() or sin_k.is_inference():
        return pack_filters(cos_k, sin_k)
    key = (sin_k, cos_k._version, sin_k._version)
    with _packed_lock:
        hit = _packed_cache.get(cos_k)
        if hit is not None and hit[0][0] is sin_k and hit[0][1:] == key[1:]:
            return hit[1]
        packed = pack_filters(cos_k, sin_k)
        _packed_cache[cos_k] = (key, packed)
        return packed


def _check(y: torch.Tensor, cos_k: torch.Tensor, sin_k: torch.Tensor,
           window_size: int, hop_length: int) -> None:
    if window_size % hop_length:
        raise ValueError(f"window_size {window_size} is not a multiple of "
                         f"hop_length {hop_length}")
    if hop_length % KC:
        raise ValueError(f"hop_length {hop_length} is not a multiple of "
                         f"{KC}")
    if y.dim() != 2:
        raise ValueError(f"audio must be (batch, samples), got "
                         f"{tuple(y.shape)}")
    if cos_k.shape != sin_k.shape or cos_k.dim() != 2 \
            or cos_k.shape[0] != window_size or cos_k.shape[1] == 0:
        raise ValueError(f"filters must both be ({window_size}, n_bins), got "
                         f"{tuple(cos_k.shape)} and {tuple(sin_k.shape)}")
    for name, t in (("audio", y), ("cos", cos_k), ("sin", sin_k)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type != "cuda" or t.device != y.device:
            raise ValueError(f"{name} must lie on the audio's CUDA device, "
                             f"got {t.device} (audio on {y.device})")


def vqt_magnitude_cuda(y: torch.Tensor, cos_k: torch.Tensor,
                       sin_k: torch.Tensor, window_size: int,
                       hop_length: int) -> torch.Tensor:
    """(B, L) f32 audio on the card -> (B, 1 + L // hop, n_bins) magnitude.

    Raises on anything the kernel does not take; never falls back.
    """
    _check(y, cos_k, sin_k, window_size, hop_length)
    lib = _library()
    batch, n_samples = y.shape
    n_frames = 1 + n_samples // hop_length
    n_bins = cos_k.shape[1]
    out = torch.empty((batch, n_frames, n_bins), dtype=torch.float32,
                      device=y.device)
    if batch:
        with torch.cuda.device(y.device):
            packed = _packed(cos_k, sin_k)
            rows = n_frames + window_size // hop_length - 1
            a_split = torch.empty((2, batch, rows, hop_length),
                                  dtype=torch.float32, device=y.device)
            stream = torch.cuda.current_stream(y.device).cuda_stream
            err = lib.vqt_mag_launch(
                y.data_ptr(), packed.data_ptr(), a_split.data_ptr(),
                out.data_ptr(), batch, n_samples, n_frames, n_bins,
                packed.shape[1], window_size, hop_length, stream)
        if err:
            raise RuntimeError(f"vqt_mag kernel launch failed: "
                               + (f"CUDA error {err}" if err > 0 else
                                  f"cuTensorMapEncodeTiled error {-err}"))
        vqt_magnitude_cuda.launches += 1
    return out


vqt_magnitude_cuda.launches = 0
