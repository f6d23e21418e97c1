"""Launch wrapper of K4, the hand-written recurrence of the greedy
encoder's 2-layer bidirectional GRU (csrc/encoder_gru.cu).

One call computes what ``nn.GRU(256, 256, num_layers=2,
bidirectional=True, batch_first=True)`` gives for an input (B, T, 256):
``enc`` (B, T, 512) and ``h_n`` (4, B, 256). Per layer, one float32 cuBLAS
product a direction computes the input half of every step (x W_ih^T +
b_ih), then one K4 launch runs both directions' recurrence, a cluster of
16 thread blocks per (direction, chunk of rows). The kernel replaces no Pallas
kernel (the JAX package's encoder is the XLA scan of
``piano_a2s_tpu/models/score_transcription.py::encoder_apply``);
``models/score_transcription.py::Encoder.forward`` calls this where
``uses_k4`` holds, and the tests hold a plain twin of the kernel's
algorithm against ``nn.GRU`` (``tests/test_torch_encoder_gru_cuda.py``).

``encoder_gru_cuda.launches`` counts the kernels launched, one a layer; a
call while a CUDA graph is being captured counts nothing.

It takes a contiguous float32 CUDA input (B, T, 256) with B, T >= 1 and a
2-layer bidirectional batch-first ``nn.GRU`` with biases of input and
hidden size 256, all float32 and contiguous on the input's device. It
raises on anything else; it never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch
import torch.nn as nn

from . import _build

HIDDEN = INPUT = 256
LAYERS = 2
CLUSTER, MAX_ROWS = 16, 64

_POINTERS = ("g_f", "g_b", "w_hh_f", "w_hh_b", "b_hh_f", "b_hh_b", "out",
             "h_n")
_INTS = ("B", "T", "H")


class _Args(ctypes.Structure):
    """csrc/encoder_gru.cu's ``EncoderGruArgs``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int) for n in _INTS])


_lock = threading.Lock()
_ready = False


def _library():
    """The built kernel library, its signatures declared and its widths
    checked against this module's."""
    global _ready
    lib = _build.load("encoder_gru")
    with _lock:
        if not _ready:
            lib.encoder_gru_dims.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.encoder_gru_dims.restype = ctypes.c_int
            lib.encoder_gru_plan.argtypes = [ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
            lib.encoder_gru_plan.restype = ctypes.c_int
            lib.encoder_gru_launch.argtypes = [ctypes.POINTER(_Args),
                                               ctypes.c_void_p]
            lib.encoder_gru_launch.restype = ctypes.c_int
            dims = (ctypes.c_int * 4)()
            lib.encoder_gru_dims(dims)
            if tuple(dims[:3]) != (HIDDEN, CLUSTER, MAX_ROWS):
                raise RuntimeError("csrc/encoder_gru.cu and ops/"
                                   "encoder_gru_cuda.py disagree on the "
                                   f"widths: {tuple(dims[:3])}")
            _ready = True
    return lib


def takes(gru: nn.Module) -> bool:
    """Whether ``gru`` has the one shape K4 is built for: the paper's
    encoder GRU (2 bidirectional batch-first layers with biases and no
    dropout between them, input and hidden size 256)."""
    return (isinstance(gru, nn.GRU) and gru.bidirectional and gru.bias
            and gru.batch_first and gru.num_layers == LAYERS
            and gru.proj_size == 0 and gru.dropout == 0
            and gru.input_size == INPUT and gru.hidden_size == HIDDEN)


def _layer_weights(gru: nn.GRU, layer: int) -> dict:
    """Layer ``layer``'s eight tensors under the kernel's names (_f
    forward, _b backward)."""
    out = {}
    for suffix, d in (("", "f"), ("_reverse", "b")):
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            kind = "weight" if name[0] == "w" else "bias"
            out[f"{name}_{d}"] = getattr(
                gru, f"{kind}_{name[2:]}_l{layer}{suffix}")
    return out


def plan(batch: int) -> Tuple[int, int, int]:
    """(rows a cluster, clusters, clusters the card holds at once) of a
    launch for ``batch`` rows on the current card."""
    out = (ctypes.c_int * 3)()
    err = _library().encoder_gru_plan(batch, out)
    if err:
        raise RuntimeError(f"encoder_gru plan failed: CUDA error {err}")
    return tuple(out)


def encoder_gru_cuda(gru: nn.GRU, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(enc (B, T, 512), h_n (4, B, 256)) of ``x`` (B, T, 256) through
    ``gru``, as ``gru(x)`` gives them. Raises on anything the kernel does
    not take."""
    if not takes(gru):
        raise ValueError("K4 takes a 2-layer bidirectional batch-first "
                         f"nn.GRU with biases of input and hidden size "
                         f"{INPUT}, got {gru}")
    if x.dim() != 3 or x.shape[0] < 1 or x.shape[1] < 1 \
            or x.shape[2] != INPUT:
        raise ValueError(f"K4 takes an input (B, T, {INPUT}) with B, T >= 1,"
                         f" got {tuple(x.shape)}")
    layers = [_layer_weights(gru, layer) for layer in range(LAYERS)]
    named = [("x", x)] + [(f"{name}_l{i}", w) for i, ws in enumerate(layers)
                          for name, w in ws.items()]
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = x.device
    for name, t in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must lie on the CUDA device of the "
                             f"input, got {t.device}")
    B, T, _ = x.shape
    H = HIDDEN
    h_n = torch.empty((2 * LAYERS, B, H), dtype=torch.float32, device=dev)
    lib = _library()
    inp = x.reshape(B * T, INPUT)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for layer, w in enumerate(layers):
            g_f = torch.addmm(w["b_ih_f"], inp, w["w_ih_f"].t())
            g_b = torch.addmm(w["b_ih_b"], inp, w["w_ih_b"].t())
            out = torch.empty((B, T, 2 * H), dtype=torch.float32, device=dev)
            args = _Args(g_f=g_f.data_ptr(), g_b=g_b.data_ptr(),
                         w_hh_f=w["w_hh_f"].data_ptr(),
                         w_hh_b=w["w_hh_b"].data_ptr(),
                         b_hh_f=w["b_hh_f"].data_ptr(),
                         b_hh_b=w["b_hh_b"].data_ptr(),
                         out=out.data_ptr(),
                         h_n=h_n[2 * layer].data_ptr(),
                         B=B, T=T, H=H)
            err = lib.encoder_gru_launch(ctypes.byref(args), stream)
            if err:
                raise RuntimeError(f"encoder_gru launch failed: CUDA error "
                                   f"{err}")
            inp = out.reshape(B * T, 2 * H)
        capturing = torch.cuda.is_current_stream_capturing()
    if not capturing:
        with _lock:
            encoder_gru_cuda.launches += LAYERS
    return out, h_n


encoder_gru_cuda.launches = 0
