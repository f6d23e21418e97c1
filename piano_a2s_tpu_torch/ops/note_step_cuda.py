"""Launch wrapper of K2, the hand-written greedy note-decoder step
(csrc/note_step.cu).

One call runs one step of both staves in place on the decode's state:
attention, GRU, head, log_softmax, argmax and the masked updates, in four
launches, and leaves the next step's [W_hh | W_q] product in the scratch
(``NoteStepWork``). ``note_step_prologue`` computes that product for a
bar's first step. The kernel replaces no Pallas kernel (the JAX package's
step is an XLA while_loop); the model's torch-op step
``models/score_transcription.py::_masked_step`` calls this for CUDA float32
operands, and the tests hold a plain twin of its algorithm against that
step (``tests/test_torch_note_step_cuda.py``).

A step's attention kernel is a programmatic dependent launch of the launch
before it: it starts while that one runs and reads v and enc_proj2 (and t,
as a hint) before waiting for it, so the launch right before a step must
not write v or enc_proj2 (a decode binds its operands several launches
ahead).

``note_step_cuda.launches`` counts the kernels launched: 4 a step, 1 a
prologue. A call while a CUDA graph is being captured launches nothing and
counts nothing; the graph's owner counts its replays (``count_launches``).

It takes CUDA tensors only, at the paper's widths (a decoder hidden of 512,
an attention width of 256, a vocabulary of at most 256), and raises on any
other dtype, layout, width or device; it never falls back.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import _build
from .note_step import MAX_CHUNKS, pick_chunks

D, H = 512, 256          # decoder hidden (= encoder width), attention width
ROW_TILE = 16            # rows of a product tile
HEAD_COLS = 32           # the head's weight is padded to a multiple of this
MAX_VOCAB = 256
STEP_LAUNCHES = 4        # attn, gru, proj, final

_POINTERS = ("w_hq", "b_hh", "b_ih", "emb_proj", "w_ih_ctx", "v", "w_out",
             "b_out", "enc", "enc_proj2", "h2", "tok2", "lengths", "done",
             "t", "caps", "live", "logp", "pred", "hq", "ctx", "part_m",
             "part_l", "part_ctx", "counters", "headp", "mask")
_INTS = ("B", "T", "V", "VP", "groups", "chunks", "chunk_frames", "eos")


class _Args(ctypes.Structure):
    """csrc/note_step.cu's ``Args``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int) for n in _INTS])


_lock = threading.Lock()
_ready_devices: set = set()


def _library(device: torch.device):
    """The built kernel library, its signatures declared, its launch
    attributes set on ``device``."""
    lib = _build.load("note_step")
    with _lock:
        if device.index not in _ready_devices:
            lib.note_step_dims.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.note_step_dims.restype = ctypes.c_int
            for fn in (lib.note_step_prologue, lib.note_step_launch):
                fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.note_step_init.argtypes = []
            lib.note_step_init.restype = ctypes.c_int
            dims = (ctypes.c_int * 8)()
            lib.note_step_dims(dims)
            if tuple(dims[:6]) != (D, H, ROW_TILE, HEAD_COLS, MAX_CHUNKS,
                                   MAX_VOCAB):
                raise RuntimeError("csrc/note_step.cu and ops/note_step_cuda"
                                   f".py disagree on the widths: "
                                   f"{tuple(dims[:6])}")
            with torch.cuda.device(device):
                err = lib.note_step_init()
            if err:
                raise RuntimeError(f"note_step init failed: CUDA error {err}")
            _ready_devices.add(device.index)
    return lib


class NoteStepWork:
    """K2's scratch for one decode shape (rows, frames, stop groups) on one
    card, with the head's weight padded to whole column tiles and a
    contiguous copy of ``w_ih_ctx`` (a strided slice of W_ih); ``bind``
    copies both from each forward's weights."""

    def __init__(self, p, rows: int, frames: int, groups: int,
                 device: torch.device):
        vocab = p.b_out.shape[-1]
        widths = (p.w_hq.shape[1], p.v.shape[-1])
        if widths != (D, H):
            raise ValueError(f"K2 is built for a decoder hidden of {D} and "
                             f"an attention width of {H}, got {widths}")
        self.rows, self.frames, self.groups = rows, frames, groups
        self.chunks, self.chunk_frames = pick_chunks(rows, frames)
        self.vocab_cols = -(-vocab // HEAD_COLS) * HEAD_COLS

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.w_out = zeros(2, 2 * D, self.vocab_cols)
        self.w_ih_ctx = zeros(*p.w_ih_ctx.shape)
        self.hq = zeros(2, rows, p.w_hq.shape[-1])
        self.ctx = zeros(2, rows, D)
        self.part_m = zeros(2, rows, self.chunks)
        self.part_l = zeros(2, rows, self.chunks)
        self.part_ctx = zeros(2, rows, self.chunks, D)
        self.counters = zeros(rows, dtype=torch.int32)
        self.headp = zeros(2, 2, rows, self.vocab_cols)
        self.mask = zeros(2, rows, dtype=torch.bool)

    def bind(self, p) -> "NoteStepWork":
        self.w_out[..., :p.w_out.shape[-1]].copy_(p.w_out)
        self.w_ih_ctx.copy_(p.w_ih_ctx)
        return self

    def weights(self, p) -> dict:
        """The weights the kernel reads: p's, and the bound copies."""
        return {"w_hq": p.w_hq, "b_hh": p.b_hh, "b_ih": p.b_ih,
                "emb_proj": p.emb_proj, "w_ih_ctx": self.w_ih_ctx, "v": p.v,
                "w_out": self.w_out, "b_out": p.b_out}


def _pointers(named: dict, shapes: dict, device: torch.device) -> dict:
    """The data pointers of ``named`` tensors (None stays None), each
    checked against its (shape, dtype) in ``shapes`` and for contiguity,
    then for lying on the CUDA ``device``."""
    given = {name: x for name, x in named.items() if x is not None}
    for name, x in given.items():
        shape, dtype = shapes[name]
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have the shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in given.items():
        if x.device.type != "cuda" or x.device != device:
            raise ValueError(f"{name} must lie on the CUDA device {device}, "
                             f"got {x.device}")
    return {name: None if x is None else x.data_ptr()
            for name, x in named.items()}


def _shapes(work: NoteStepWork, vocab: int) -> dict:
    """(shape, dtype) of every tensor the kernel takes."""
    B, T, n_gates = work.rows, work.frames, 3 * D
    f32, i64, b8 = torch.float32, torch.int64, torch.bool
    return {
        "w_hq": ((2, D, n_gates + H), f32), "b_hh": ((2, n_gates), f32),
        "b_ih": ((2, n_gates), f32), "emb_proj": ((2, vocab, n_gates), f32),
        "w_ih_ctx": ((2, D, n_gates), f32), "v": ((2, H), f32),
        "w_out": ((2, 2 * D, work.vocab_cols), f32),
        "b_out": ((2, vocab), f32), "enc": ((B, T, D), f32),
        "enc_proj2": ((2, B, T, H), f32), "h2": ((2, B, D), f32),
        "tok2": ((2, B, n_gates), f32), "lengths": ((2, B), i64),
        "done": ((2, B), b8), "t": ((), i64), "caps": ((2, 1), i64),
        "live": ((2, work.groups), b8), "logp": ((2, B, vocab), f32),
        "pred": ((2, B), i64), "hq": ((2, B, n_gates + H), f32),
        "ctx": ((2, B, D), f32), "part_m": ((2, B, work.chunks), f32),
        "part_l": ((2, B, work.chunks), f32),
        "part_ctx": ((2, B, work.chunks, D), f32),
        "counters": ((B,), torch.int32),
        "headp": ((2, 2, B, work.vocab_cols), f32), "mask": ((2, B), b8)}


def count_launches(n: int) -> None:
    """Add ``n`` kernels launched outside a call (a graph's replay)."""
    with _lock:
        note_step_cuda.launches += n


def _launch(fn, args: _Args, device: torch.device, what: str,
            kernels: int) -> None:
    with torch.cuda.device(device):
        err = fn(ctypes.byref(args),
                 torch.cuda.current_stream(device).cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err:
        raise RuntimeError(f"note_step {what} failed: CUDA error {err}")
    if not capturing:
        count_launches(kernels)


def note_step_prologue(p, work: NoteStepWork, h2: torch.Tensor) -> None:
    """The first step's [W_hh | W_q] product of ``h2`` (2, rows, 512) into
    the scratch."""
    dev = h2.device
    ptrs = _pointers({"w_hq": work.weights(p)["w_hq"], "h2": h2,
                      "hq": work.hq},
                     _shapes(work, p.b_out.shape[-1]), dev)
    _launch(_library(dev).note_step_prologue, _Args(B=work.rows, **ptrs),
            dev, "prologue", 1)


def note_step_cuda(p, work: NoteStepWork, enc: torch.Tensor,
                   enc_proj2: torch.Tensor, h2: torch.Tensor,
                   tok2: torch.Tensor, lengths: torch.Tensor,
                   done: torch.Tensor, t: torch.Tensor, caps: torch.Tensor,
                   logp: torch.Tensor, pred: torch.Tensor, eos: int,
                   live: Optional[torch.Tensor] = None) -> None:
    """One step in place: h2, tok2, lengths, done and t updated, logp
    (2, rows, vocab)
    and pred (2, rows) written; ``live`` (2, groups) bool, where given,
    says which stop groups step in place of the done flags. Raises on
    anything the kernel does not take."""
    dev, vocab = enc.device, p.b_out.shape[-1]
    if vocab > MAX_VOCAB:
        raise ValueError(f"a vocabulary of {vocab} exceeds the kernel's "
                         f"{MAX_VOCAB}")
    named = dict(work.weights(p), enc=enc, enc_proj2=enc_proj2, h2=h2,
                 tok2=tok2, lengths=lengths, done=done, t=t, caps=caps,
                 live=live, logp=logp, pred=pred, hq=work.hq, ctx=work.ctx,
                 part_m=work.part_m, part_l=work.part_l,
                 part_ctx=work.part_ctx, counters=work.counters,
                 headp=work.headp, mask=work.mask)
    ptrs = _pointers(named, _shapes(work, vocab), dev)
    args = _Args(B=work.rows, T=work.frames, V=vocab, VP=work.vocab_cols,
                 groups=work.groups, chunks=work.chunks,
                 chunk_frames=work.chunk_frames, eos=eos, **ptrs)
    _launch(_library(dev).note_step_launch, args, dev, "launch",
            STEP_LAUNCHES)


note_step_cuda.launches = 0
