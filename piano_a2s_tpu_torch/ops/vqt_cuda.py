"""Launch wrapper of the hand-written VQT magnitude kernel (csrc/vqt_mag.cu).

The kernel replaces the JAX package's Pallas kernel
(piano_a2s_tpu/ops/vqt_pallas.py::_vqt_kernel). It takes CUDA tensors only;
the plain PyTorch version is ``ops.vqt.vqt_magnitude_torch``, and
``ops.vqt.vqt_magnitude`` picks between the two by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_KC = 32  # the kernel's filter chunk (taps); must divide hop_length
_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use


def _library():
    """The built kernel library, with its C signatures declared."""
    lib = _build.load("vqt_mag")
    lib.vqt_mag_launch.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.vqt_mag_launch.restype = ctypes.c_int
    lib.vqt_mag_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.vqt_mag_smem_bytes.restype = ctypes.c_int
    return lib


def _check(y: torch.Tensor, cos_k: torch.Tensor, sin_k: torch.Tensor,
           window_size: int, hop_length: int) -> None:
    if window_size % hop_length:
        raise ValueError(f"window_size {window_size} is not a multiple of "
                         f"hop_length {hop_length}")
    if hop_length % _KC:
        raise ValueError(f"hop_length {hop_length} is not a multiple of "
                         f"{_KC}")
    if y.dim() != 2:
        raise ValueError(f"audio must be (batch, samples), got "
                         f"{tuple(y.shape)}")
    if cos_k.shape != sin_k.shape or cos_k.dim() != 2 \
            or cos_k.shape[0] != window_size:
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
    rows = window_size // hop_length
    smem = lib.vqt_mag_smem_bytes(hop_length, rows)
    if smem > _MAX_SMEM:
        raise ValueError(f"window_size {window_size} needs {smem} bytes of "
                         f"shared memory per block (limit {_MAX_SMEM})")
    pad = window_size // 2
    y_pad = F.pad(y, (pad, pad))
    batch, padded_len = y_pad.shape
    n_frames = 1 + y.shape[1] // hop_length
    n_bins = cos_k.shape[1]
    out = torch.empty((batch, n_frames, n_bins), dtype=torch.float32,
                      device=y.device)
    if batch and n_frames:
        with torch.cuda.device(y.device):
            stream = torch.cuda.current_stream(y.device).cuda_stream
            err = lib.vqt_mag_launch(
                y_pad.data_ptr(), cos_k.data_ptr(), sin_k.data_ptr(),
                out.data_ptr(), batch, padded_len, n_frames, n_bins,
                hop_length, rows, stream)
        if err:
            raise RuntimeError(f"vqt_mag kernel launch failed: CUDA error "
                               f"{err}")
        vqt_magnitude_cuda.launches += 1
    return out


vqt_magnitude_cuda.launches = 0
