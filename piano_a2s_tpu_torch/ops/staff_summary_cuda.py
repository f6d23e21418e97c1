"""Launch wrapper of K3, the hand-written staff summaries
(csrc/staff_summary.cu).

One call computes the final bidirectional hidden of S x B token sequences
(``ops/gru.py::bidir_final_fused`` of their embeddings, with
``pack_padded_sequence``'s semantics) in one launch: the embedding lookup,
both directions of the staff GRU, the lengths read on the card. The kernel
replaces no Pallas kernel (the JAX package's staff summary is the XLA scan
of ``piano_a2s_tpu/ops/gru.py::bidir_final_fused``);
``models/score_transcription.py::HierarchicalDecoder.staff_summaries``
calls this where ``uses_k3`` holds, and the tests hold a plain twin of the
kernel's per-warp algorithm against the packed call
(``tests/test_torch_staff_summary_cuda.py``).

``staff_summary_cuda.launches`` counts the kernels launched, one a call; a
call while a CUDA graph is being captured counts nothing.

It takes CUDA tensors only: int64 tokens (S, B, T) and lengths (S, B), each
length in [1, T] (not read back: the callers guarantee it), a float32
embedding table (V, E), and a single-layer bidirectional batch-first
``nn.GRU`` with biases whose hidden size is at most 32 and input size at
most 64, all float32 on the tokens' device. It raises on anything else; it
never falls back.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn as nn

from . import _build

MAX_HIDDEN, MAX_INPUT, WARPS = 32, 64, 4

_POINTERS = ("tokens", "lengths", "emb", "w_ih_f", "w_hh_f", "b_ih_f",
             "b_hh_f", "w_ih_b", "w_hh_b", "b_ih_b", "b_hh_b", "out")
_INTS = ("N", "T", "V", "E", "H")


class _Args(ctypes.Structure):
    """csrc/staff_summary.cu's ``StaffSummaryArgs``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int) for n in _INTS])


_lock = threading.Lock()
_ready = False


def _library():
    """The built kernel library, its signatures declared and its widths
    checked against this module's."""
    global _ready
    lib = _build.load("staff_summary")
    with _lock:
        if not _ready:
            lib.staff_summary_dims.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.staff_summary_dims.restype = ctypes.c_int
            lib.staff_summary_launch.argtypes = [ctypes.POINTER(_Args),
                                                 ctypes.c_void_p]
            lib.staff_summary_launch.restype = ctypes.c_int
            dims = (ctypes.c_int * 4)()
            lib.staff_summary_dims(dims)
            if tuple(dims[:3]) != (MAX_HIDDEN, MAX_INPUT, WARPS):
                raise RuntimeError("csrc/staff_summary.cu and ops/"
                                   "staff_summary_cuda.py disagree on the "
                                   f"widths: {tuple(dims[:3])}")
            _ready = True
    return lib


def _gru_weights(gru: nn.GRU) -> dict:
    """The kernel's view of ``gru``'s eight tensors; raises on a GRU it
    does not take."""
    if not (isinstance(gru, nn.GRU) and gru.bidirectional
            and gru.num_layers == 1 and gru.batch_first and gru.bias
            and gru.proj_size == 0):
        raise ValueError("K3 takes a single-layer bidirectional batch-first "
                         "nn.GRU with biases")
    if gru.hidden_size > MAX_HIDDEN or gru.input_size > MAX_INPUT:
        raise ValueError(f"K3 takes a hidden size of at most {MAX_HIDDEN} "
                         f"and an input size of at most {MAX_INPUT}, got "
                         f"{gru.hidden_size} and {gru.input_size}")
    out = {}
    for suffix, d in (("", "f"), ("_reverse", "b")):
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            kind = "weight" if name[0] == "w" else "bias"
            out[f"{name}_{d}"] = getattr(gru, f"{kind}_{name[2:]}_l0{suffix}")
    return out


def staff_summary_cuda(gru: nn.GRU, emb: torch.Tensor, tokens: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """(S, B, 2H): [final forward h ; final backward h] of each sequence
    of ``tokens`` (S, B, T) cut to its ``lengths`` (S, B), embedded by
    ``emb`` (V, E), through ``gru``. Raises on anything the kernel does not
    take."""
    if tokens.dim() != 3 or tokens.shape[2] < 1 or emb.dim() != 2 \
            or emb.shape[0] < 1:
        raise ValueError("K3 takes tokens (S, B, T) with T >= 1 and an "
                         f"embedding table (V, E), got {tuple(tokens.shape)}"
                         f" and {tuple(emb.shape)}")
    S, B, T = tokens.shape
    H, E = gru.hidden_size, gru.input_size
    shapes = {"tokens": ((S, B, T), torch.int64),
              "lengths": ((S, B), torch.int64),
              "emb": ((emb.shape[0], E), torch.float32),
              "w_ih_f": ((3 * H, E), torch.float32),
              "w_hh_f": ((3 * H, H), torch.float32),
              "b_ih_f": ((3 * H,), torch.float32),
              "b_hh_f": ((3 * H,), torch.float32)}
    for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        shapes[f"{name}_b"] = shapes[f"{name}_f"]
    named = dict(_gru_weights(gru), tokens=tokens, lengths=lengths, emb=emb)
    dev = tokens.device
    for name, x in named.items():
        shape, dtype = shapes[name]
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have the shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in named.items():
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name} must lie on the CUDA device of the "
                             f"tokens, got {x.device}")
    out = torch.empty((S, B, 2 * H), dtype=torch.float32, device=dev)
    args = _Args(N=S * B, T=T, V=emb.shape[0], E=E, H=H, out=out.data_ptr(),
                 **{name: x.data_ptr() for name, x in named.items()})
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.staff_summary_launch(
            ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err:
        raise RuntimeError(f"staff_summary launch failed: CUDA error {err}")
    if not capturing and S * B:
        with _lock:
            staff_summary_cuda.launches += 1
    return out


staff_summary_cuda.launches = 0
