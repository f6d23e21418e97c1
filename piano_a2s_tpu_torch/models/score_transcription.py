"""ScoreTranscription model (PyTorch): greedy inference and the
teacher-forced training forward.

Port of piano_a2s_tpu/models/score_transcription.py:

    spectrogram (B, 1, T=1201, F=480)
      -> ConvStack: 4x [3x3 conv + BN + ReLU] -> flatten (C, F) -> Linear+BN
         -> (B, T, 256)
      -> Encoder: 2-layer bidirectional GRU -> enc (B, T, 512), bridge
         hidden (B, 512)
      -> HierarchicalDecoder: per bar, a GRU step with additive attention
         gives the bar summary; two note decoders (upper and lower staff)
         decode greedily (one loop, ``_NoteDecode``: replayed CUDA graphs
         on a card, single steps elsewhere) or, given ground truth,
         teacher-forced; MLP heads give time and key signature.

Parameter names are those of the torch reference state dict (the keys
``piano_a2s_tpu.models.convert.to_torch_state_dict`` emits), so a converted
JAX checkpoint or an upstream checkpoint loads strictly. The BatchNorm
state is the modules' running buffers, which a training forward writes in
place.

Data parallelism (``group``, a torch.distributed process group whose ranks
each hold their rows of the batch, ``rows`` placing them): the training
forward takes the global batch's BatchNorm statistics, draws its dropout
masks at the global batch's shape and keeps its rows, and takes the
decode's batch-coupled
stop step over every rank's targets; the greedy decode stops when every
rank's items have stopped (an all-reduce after each step). So N ranks
compute what one rank computes on the joined rows, as the JAX package's
one program over a device mesh does. Serving shards
(infer.Transcriber(use_mesh=True)) pass no group: each stops on its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops import attention as A
from ..ops import encoder_gru_cuda as K4
from ..ops import gru as G
from ..ops import layers as L
from ..ops import note_step_cuda as K2
from ..ops import staff_summary_cuda as K3
from ..ops.note_step import step_mask
from ..utils import profiling as P

CONV_CHANNELS = (20, 20, 40, 40)


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x in ``dtype``, or as it is for None (full precision)."""
    return x if dtype is None else x.to(dtype)


def _dropout(x: torch.Tensor, rate: float, train: bool,
             generator: Optional[torch.Generator], group,
             axis: int = 0,
             rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """L.dropout of x, whose batch axis is ``axis``; under ``group`` x is
    this rank's rows and the mask is cut from the global batch's: the rows
    [start, start + B) of ``total`` for ``rows`` = (start, total), or by
    default the rank's equal share."""
    if group is None:
        return L.dropout(x, rate, train, generator)
    b = x.shape[axis]
    start, total = rows or (dist.get_rank(group) * b,
                            dist.get_world_size(group) * b)
    return L.dropout(x, rate, train, generator, rows=(axis, start, total))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    in_channels: int = 1
    freq_bins: int = 480
    conv_feature_size: int = 256
    hidden_size: int = 256
    max_bars: int = 5
    num_time_sig: int = 7
    num_keys: int = 14
    max_length: Tuple[int, int] = (398, 189)
    note_emb_size: int = 16
    staff_emb_size: int = 32
    time_sig_emb_size: int = 5
    key_emb_size: int = 8
    vocab_size: int = 173
    sos: int = 145
    eos: int = 146
    pad: int = 147
    newline: int = 143

    @property
    def bar_gru_in(self) -> int:
        return (self.staff_emb_size * 4 + self.time_sig_emb_size
                + self.key_emb_size + self.hidden_size * 2)

    @property
    def note_gru_in(self) -> int:
        return self.note_emb_size + self.hidden_size * 2


# ---------------------------------------------------------------------------
# ConvStack + Encoder
# ---------------------------------------------------------------------------

class ConvStack(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        chans = (cfg.in_channels,) + CONV_CHANNELS
        for i in range(1, 5):
            setattr(self, f"conv{i}", nn.Conv2d(chans[i - 1], chans[i], 3,
                                                padding=1, bias=False))
            setattr(self, f"bn{i}", nn.BatchNorm2d(chans[i]))
        self.out = nn.Linear(CONV_CHANNELS[-1] * cfg.freq_bins,
                             cfg.conv_feature_size, bias=False)
        self.out_bn = nn.BatchNorm1d(cfg.conv_feature_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval: x (B, C_in, T, F) -> (B, T, conv_feature_size).

        Each BatchNorm's running statistics are folded into the preceding
        conv / the flatten linear (in at least float32). The flatten is
        torch's (C, F) order, c * F + f.
        """
        y = x
        for i in range(1, 5):
            w, b = L.fold_bn(getattr(self, f"conv{i}").weight,
                             getattr(self, f"bn{i}"), dtype=y.dtype)
            y = F.relu(L.conv2d_same(y, w, b))
        bsz, c, t, f = y.shape
        y = y.permute(0, 2, 1, 3).reshape(bsz, t, c * f)
        w, b = L.fold_bn(self.out.weight, self.out_bn, self.out.bias,
                         dtype=y.dtype)
        return F.relu(L.linear(y, w, b))

    def forward_train(self, x: torch.Tensor,
                      sample_weight: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      compute_dtype: Optional[torch.dtype] = None,
                      group=None,
                      rows: Optional[Tuple[int, int]] = None,
                      counted: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Train: x (B, C_in, T, F) -> (B, T, conv_feature_size).

        Conv, BatchNorm on the batch statistics (weighted by
        ``sample_weight``; the running buffers are written) and ReLU per
        layer, nothing folded; the flatten, the linear and ``out_bn``;
        then dropout 0.2.

        ``compute_dtype`` (bf16 conv training): the input and the
        activations are in that dtype and the conv and linear weights are
        cast to it at use (the parameters and their gradients stay
        float32); each BatchNorm computes its statistics and normalisation
        in float32 and returns the compute dtype
        (``L.batch_norm_relu_train``, which saves no float32 activation for
        the backward). The result is in the compute dtype.

        ``group`` (data parallelism): x is this rank's rows; all five
        BatchNorms take the global batch's statistics and the dropout mask
        is this rank's rows of the global one (at ``rows``, see _dropout).
        ``counted`` (B,) 0/1: the rows the BatchNorm statistics count when
        every weight is 0 (default all; 0 marks a data-parallel stand-in).
        """
        def bn_relu(y, bn, axes):
            if compute_dtype is None:
                return F.relu(L.batch_norm_train(y, bn, axes=axes,
                                                 weight=sample_weight,
                                                 group=group,
                                                 counted=counted))
            return L.batch_norm_relu_train(y, bn, axes, sample_weight, group,
                                           counted)

        y = _cast(x, compute_dtype)
        for i in range(1, 5):
            y = L.conv2d_same(y, getattr(self, f"conv{i}").weight.to(y.dtype))
            y = bn_relu(y, getattr(self, f"bn{i}"), (0, 2, 3))
        bsz, c, t, f = y.shape
        y = y.permute(0, 2, 1, 3).reshape(bsz, t, c * f)
        y = L.linear(y, self.out.weight.to(y.dtype), self.out.bias)
        y = bn_relu(y, self.out_bn, (0, 1))
        return _dropout(y, 0.2, True, generator, group, rows=rows)


def uses_k4(x: torch.Tensor, gru: nn.GRU) -> bool:
    """Whether the encoder's GRU over ``x`` runs K4, the hand-written
    recurrence (``ops/encoder_gru_cuda.py``): input on a card, float32
    input and weights, and no gradient recorded (grad off, or neither the
    input nor a weight requires it). Every other call runs ``nn.GRU``: the
    CPU's, float64's and training's (cuDNN's backward). Decided by what the
    call can see alone: a call on a card at widths K4 is not built for
    raises in its wrapper rather than fall back."""
    weights = list(gru.parameters())
    return (x.is_cuda and x.dtype == torch.float32
            and all(w.dtype == torch.float32 for w in weights)
            and not (torch.is_grad_enabled()
                     and (x.requires_grad
                          or any(w.requires_grad for w in weights))))


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_size
        self.gru = nn.GRU(cfg.conv_feature_size, h, num_layers=2,
                          bidirectional=True, batch_first=True)
        self.fc = nn.Linear(2 * h, h)

    def forward(self, x: torch.Tensor):
        """x (B, T, F_in) -> (enc (B, T, 2H), bridge hidden (B, 2H)).

        The GRU is K4 where ``uses_k4`` holds, else ``nn.GRU``. Counts
        ``encoder_rows`` (B) and ``encoder_kernel_rows`` (B where K4 ran,
        else 0) on the enclosing span (``forward/encoder``).

        Bridge: per layer tanh(fc([h_fwd; h_bwd])), the two layers
        concatenated.
        """
        kernel = uses_k4(x, self.gru)
        P.count("encoder_rows", x.shape[0])
        P.count("encoder_kernel_rows", x.shape[0] if kernel else 0)
        if kernel:
            enc, h_n = K4.encoder_gru_cuda(self.gru, x.contiguous())
        else:
            enc, h_n = self.gru(x)
        # h_n: (l0 fwd, l0 bwd, l1 fwd, l1 bwd)
        h1 = torch.tanh(self.fc(torch.cat([h_n[0], h_n[1]], dim=-1)))
        h2 = torch.tanh(self.fc(torch.cat([h_n[2], h_n[3]], dim=-1)))
        return enc, torch.cat([h1, h2], dim=-1)


# ---------------------------------------------------------------------------
# Note-level decoder
# ---------------------------------------------------------------------------

class NoteDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_size
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.note_emb_size)
        self.attn = A.Attention(h)
        self.gru = nn.GRU(cfg.note_gru_in, 2 * h)
        self.out = nn.Linear(4 * h, cfg.vocab_size)


def _stack_staves(upper: NoteDecoder, lower: NoteDecoder,
                  dtype: Optional[torch.dtype] = None) -> tuple:
    """Both staves' weights stacked on a leading axis of 2, right-multiply
    layouts: (emb, w_q, v, w_ih, b_ih, w_hh, b_hh, w_out, b_out), each
    cast to ``dtype`` if given (the bf16 decode's operands). Differentiable:
    the stack and the cast are part of the graph."""
    def both(fn):
        return _cast(torch.stack([fn(upper), fn(lower)]), dtype)

    return (
        both(lambda d: d.embedding.weight),                       # (2, V, E)
        both(lambda d: d.attn.w_query).transpose(1, 2),           # (2, 2H, H)
        both(lambda d: d.attn.v.weight[0]),                       # (2, H)
        both(lambda d: d.gru.weight_ih_l0).transpose(1, 2),
        both(lambda d: d.gru.bias_ih_l0),
        both(lambda d: d.gru.weight_hh_l0).transpose(1, 2),
        both(lambda d: d.gru.bias_hh_l0),
        both(lambda d: d.out.weight).transpose(1, 2),             # (2, 4H, V)
        both(lambda d: d.out.bias))


@dataclasses.dataclass
class DualDecodeParams:
    """Upper and lower staff decoder weights stacked on a leading axis of 2,
    rearranged for the greedy step (right-multiply layouts)."""
    w_hq: torch.Tensor      # (2, 2H, 3*2H + H): [W_hh | W_query]
    b_hh: torch.Tensor      # (2, 3*2H)
    b_ih: torch.Tensor      # (2, 3*2H)
    emb_proj: torch.Tensor  # (2, V, 3*2H): embedding @ W_ih[token part]
    w_ih_ctx: torch.Tensor  # (2, 2H, 3*2H): W_ih[context part]
    v: torch.Tensor         # (2, H)
    w_out: torch.Tensor     # (2, 4H, V)
    b_out: torch.Tensor     # (2, V)


def dual_decode_params(upper: NoteDecoder, lower: NoteDecoder,
                       cfg: ModelConfig,
                       dtype: Optional[torch.dtype] = None
                       ) -> DualDecodeParams:
    """Stack both staves' weights and apply the two exact rewrites of the
    greedy step: the query projection rides in the recurrent matmul
    (h @ [W_hh | W_q]), and the token-side input projection is folded into
    the embedding table (emb @ W_ih_tok), so embed + matmul is one gather.

    With ``dtype`` (bf16 decode) the weights are cast first and folded
    after, as the JAX package does: the folded table is a bf16 product of
    bf16 operands, not the cast of a float32 product (the two can differ
    by a bf16 ulp, enough to flip a greedy token).
    """
    E = cfg.note_emb_size
    emb, w_q, v, w_ih, b_ih, w_hh, b_hh, w_out, b_out = _stack_staves(
        upper, lower, dtype)
    return DualDecodeParams(
        w_hq=torch.cat([w_hh, w_q], dim=2), b_hh=b_hh, b_ih=b_ih,
        emb_proj=torch.bmm(emb, w_ih[:, :E]), w_ih_ctx=w_ih[:, E:], v=v,
        w_out=w_out, b_out=b_out)


def _tok_proj(p: DualDecodeParams, ids2: torch.Tensor) -> torch.Tensor:
    """Per-staff lookup of the folded token projection: (2, B) -> (2, B, K)."""
    return p.emb_proj[torch.arange(2, device=ids2.device)[:, None], ids2]


def _fast_step(p: DualDecodeParams, enc: torch.Tensor,
               enc_proj2: torch.Tensor, h2: torch.Tensor,
               tokp2: torch.Tensor):
    """One greedy step of both staves: attention -> GRU -> head.
    Returns (h2', logp2 (2, B, V), pred2 (2, B))."""
    n_gates = p.b_hh.shape[-1]
    hq = torch.bmm(h2, p.w_hq)
    h_proj2 = hq[..., :n_gates] + p.b_hh[:, None]
    q2 = hq[..., n_gates:]
    energy = torch.tanh(enc_proj2 + q2[:, :, None, :])       # (2, B, T, H)
    scores = torch.einsum("sbth,sh->sbt", energy, p.v)
    weights = torch.softmax(scores.to(L.float32_or_wider(scores.dtype)),
                            dim=-1).to(enc.dtype)
    ctx2 = torch.einsum("sbt,bth->sbh", weights, enc)
    x_proj2 = tokp2 + torch.bmm(ctx2, p.w_ih_ctx) + p.b_ih[:, None]
    h2_new = G.gru_gates(x_proj2, h_proj2, h2)
    out = torch.bmm(torch.cat([h2_new, ctx2], dim=-1), p.w_out) \
        + p.b_out[:, None]
    logp2 = torch.log_softmax(out.to(L.float32_or_wider(out.dtype)), dim=-1)
    return h2_new, logp2, logp2.argmax(dim=-1)


def uses_k2(enc: torch.Tensor) -> bool:
    """Whether a greedy note step of these operands runs K2, the
    hand-written step kernel (``ops/note_step_cuda.py``): float32 operands
    on a card. Every other step runs as torch ops around ``_fast_step``:
    the CPU's, and on a card the bf16 decode's (until a bf16 kernel exists)
    and float64's. Decided by the tensor's device and dtype alone: a
    float32 decode on a card at widths K2 is not built for raises in its
    wrapper rather than fall back."""
    return enc.is_cuda and enc.dtype == torch.float32


def uses_k3(tokens: torch.Tensor, *modules: nn.Module) -> bool:
    """Whether staff summaries of ``tokens`` through ``modules`` (the note
    embedding and the staff GRU) run K3, the hand-written kernel
    (``ops/staff_summary_cuda.py``): tokens on a card, float32 weights and
    no gradient needed (grad off, or no weight requires it). Every other
    call runs the packed ``nn.GRU`` (``ops/gru.py::bidir_final_fused``): the
    CPU's, float64's, and the teacher-forced forward's in training, whose
    backward is cuDNN's. Decided by what the call can see alone: a call on
    a card at widths K3 is not built for raises in its wrapper rather than
    fall back."""
    weights = [w for m in modules for w in m.parameters()]
    return (tokens.is_cuda
            and all(w.dtype == torch.float32 for w in weights)
            and not (torch.is_grad_enabled()
                     and any(w.requires_grad for w in weights)))


class _DecodeState:
    """A greedy note decode's state, which each step updates in place: the
    hidden states ``h2`` (2, B, 2H), the projected last tokens ``tok2``
    (2, B, 3*2H), ``lengths`` and ``done`` (2, B), the steps run ``t`` (a
    0-dim tensor), the staves' ``caps`` (2, 1), the stop ``groups`` and,
    where the steps run K2 (``uses_k2``), its scratch ``work``."""

    def __init__(self, p: DualDecodeParams, cfg: ModelConfig,
                 enc: torch.Tensor, chunk: Optional[int]):
        B, dev = enc.shape[0], enc.device
        self.groups = B // chunk if chunk else 1
        self.caps = torch.tensor(cfg.max_length, device=dev)[:, None]
        self.h2 = torch.empty((2, B, p.w_hq.shape[1]), dtype=enc.dtype,
                              device=dev)
        self.tok2 = torch.empty((2, B, p.emb_proj.shape[-1]),
                                dtype=p.emb_proj.dtype, device=dev)
        self.lengths = torch.empty((2, B), dtype=torch.long, device=dev)
        self.done = torch.empty((2, B), dtype=torch.bool, device=dev)
        self.t = torch.empty((), dtype=torch.long, device=dev)
        self.work = (K2.NoteStepWork(p, B, enc.shape[1], self.groups, dev)
                     if uses_k2(enc) else None)

    def bind(self, p: DualDecodeParams) -> "_DecodeState":
        """Take a forward's weights (K2 pads the head's)."""
        if self.work is not None:
            self.work.bind(p)
        return self

    def reset(self, p: DualDecodeParams, h0: torch.Tensor,
              tok0: torch.Tensor) -> None:
        """A bar's start from the bar summary ``h0`` (B, 2H) and the
        projected <sos> ``tok0``; K2 computes the first step's query."""
        self.h2.copy_(h0.expand_as(self.h2))
        self.tok2.copy_(tok0)
        self.lengths.copy_(self.caps.expand_as(self.lengths))
        self.done.zero_()
        self.t.zero_()
        if self.work is not None:
            K2.note_step_prologue(p, self.work, self.h2)


def _masked_step(p: DualDecodeParams, cfg: ModelConfig, enc: torch.Tensor,
                 enc_proj2: torch.Tensor, st: _DecodeState,
                 logp: torch.Tensor, pred: torch.Tensor,
                 live: Optional[torch.Tensor] = None) -> None:
    """One greedy step of both staves in place on the decode state ``st``
    (the step ``_NoteDecode`` runs), kept only in the rows of the (staff,
    group) pairs still decoding: those under their staff's cap whose group
    is ``live`` ((2, groups) bool, the all-reduced flag under a
    data-parallel group; by default, some row of the group has not emitted
    EOS). Elsewhere the state stays, and the step's log-probs and tokens,
    written into ``logp`` (2, B, V) and ``pred`` (2, B), are zero.
    ``st.t`` counts the step; a row that emits EOS here gets it (the step's
    index plus one) as its length.

    CUDA float32 operands (``uses_k2``) run K2, which reads none of an
    inactive pair's operands; every other step runs the torch ops below
    around ``_fast_step`` (looked up on the module at each call)."""
    if uses_k2(enc):
        K2.note_step_cuda(p, st.work, enc, enc_proj2, st.h2, st.tok2,
                          st.lengths, st.done, st.t, st.caps, logp, pred,
                          cfg.eos, live)
        return
    m = step_mask(st.done, st.t, st.caps, st.groups, live)
    st.t += 1
    h2_new, logp2, pred2 = _fast_step(p, enc, enc_proj2, st.h2, st.tok2)
    m3 = m[:, :, None]
    st.h2.copy_(torch.where(m3, h2_new, st.h2))
    logp.copy_(torch.where(m3, logp2, 0.0))
    pred.copy_(torch.where(m, pred2, 0))
    is_eos = (pred2 == cfg.eos) & m
    st.lengths.copy_(torch.where(is_eos, st.t, st.lengths))
    st.done |= is_eos
    st.tok2.copy_(torch.where(m3, _tok_proj(p, pred2), st.tok2))


def _per_staff(logps, preds, lengths, caps) -> tuple:
    """(T, 2, B, ...) buffers -> per staff (logp (B, T_s, V), tokens
    (B, T_s), lengths (B,))."""
    return tuple((logps[:cap, s].transpose(0, 1),
                  preds[:cap, s].transpose(0, 1), lengths[s])
                 for s, cap in enumerate(caps))


# Steps one replay of a greedy note decode graph runs (K). The host reads
# the stop flags once a replay: a longer replay spreads that read (a wait
# for the card) and the launch over more steps, a shorter one computes
# fewer steps past the stop (at most K - 1 a bar, whose rows the mask
# discards). Chosen on the card (PERF.md).
GRAPH_STEPS = 16


@contextlib.contextmanager
def _workspaces_in_pool():
    """Around a CUDA graph capture: cuBLAS keeps a workspace for each pair
    of handle (one a thread) and stream, 32 MiB on an H100, allocated at
    the pair's first matmul and held for the process. Cleared before the
    capture, the pairs the capture uses allocate theirs inside the graph's
    private pool; cleared after, those return to the pool, free: the
    graph's kernels go on using them, and only a capture into that pool
    allocates there. So a graph holds no allocated memory for them (a
    capture's side stream would otherwise hold 32 MiB for the process, and
    the teacher graphs' two threads 64). Every capture in the port does
    this, so a clear never frees a workspace a graph uses outside its pool
    (as PyTorch's inductor does around its graphs); the pairs outside any
    capture allocate theirs again at their next matmul."""
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    try:
        yield
    finally:
        torch._C._cuda_clearCublasWorkspaces()


class _NoteDecode:
    """The port's greedy note decode of one shape (rows, stop groups,
    dtype, device, enc's length): blocks of ``k`` masked steps
    (``_masked_step``) in place on a static decode state, run until every
    (staff, group) pair has stopped.

    The steps read and write only the static buffers made here: each
    forward copies its enc, projections and weights in (``bind``; the
    buffers are contiguous, as K2 reads whole frames), each bar its bar
    summary (``decode``), and the host copies each block's log-probs and
    tokens out into the call's own tensors. A step's mask is made on the
    card from the done flags and the step counter (t < each staff's cap),
    and a step after every pair has stopped changes nothing, so blocks of
    any ``k`` give what single steps give. The host reads the (2, groups)
    stop flags once a block. CUDA float32 steps are K2's launches
    (``uses_k2``).

    ``_NoteGraphs.bound`` picks one of two ways of running it from what it
    can observe:
    - captured (``runs_as_graph``: a card, no ``group``, no gradients):
      k = ``GRAPH_STEPS`` and a block is one replay of a CUDA graph
      (``capture``). The instance is kept per shape, so one decode at a
      time per model: the buffers are shared.
    - uncaptured (the CPU, a data-parallel ``group``, gradients on): k = 1
      and a fresh instance per forward, so calls are reentrant. Under
      ``group`` the stop read after each step is an all-reduce of each
      staff's count of rows still decoding, and its result is the next
      step's ``live``: every rank makes the same collectives and stops at
      the same step, and a rank's finished rows step on while any rank's
      rows decode, as in the JAX package's one loop over the global batch.

    While tracing, ``decode`` counts on the innermost open span
    ``note_steps`` (the steps run, past the stop too), ``graph_steps``
    (those run in replays), ``stop_read_ns`` (the host's wall in the stop
    reads), ``rows_computed`` (2 x B a step: both staves' rows are always
    stepped) and ``rows_active`` (the rows of the (staff, group) pairs
    still decoding, from the stop steps the tokens give; under ``group``,
    this rank's own stop).
    """

    def __init__(self, p: DualDecodeParams, cfg: ModelConfig,
                 enc: torch.Tensor, enc_proj2: torch.Tensor,
                 chunk: Optional[int], k: int, group=None):
        B, dev = enc.shape[0], enc.device
        self.cfg, self.k, self.group, self.graph = cfg, k, group, None
        # Plain tensors even under inference_mode, so that a later call
        # under no_grad can copy into them.
        with torch.inference_mode(False):
            self.p = DualDecodeParams(**{
                f.name: torch.empty_like(getattr(p, f.name))
                for f in dataclasses.fields(DualDecodeParams)})
            # Contiguous whatever the operands' strides (K2 reads whole
            # frames), so that bind's copy is the only one.
            self.enc = torch.empty(enc.shape, dtype=enc.dtype, device=dev)
            self.enc_proj2 = torch.empty(enc_proj2.shape,
                                         dtype=enc_proj2.dtype, device=dev)
            self.st = _DecodeState(p, cfg, enc, chunk)
            self.sos = torch.full((2, B), cfg.sos, dtype=torch.long,
                                  device=dev)
            self.tok0 = torch.empty((2, B, p.emb_proj.shape[-1]),
                                    dtype=p.emb_proj.dtype, device=dev)
            self.logp = torch.empty((k, 2, B, cfg.vocab_size),
                                    dtype=L.float32_or_wider(enc.dtype),
                                    device=dev)
            self.pred = torch.empty((k, 2, B), dtype=torch.long, device=dev)
            self.stopped = torch.empty((2, self.st.groups), dtype=torch.bool,
                                       device=dev)

    def bind(self, p: DualDecodeParams, enc: torch.Tensor,
             enc_proj2: torch.Tensor) -> "_NoteDecode":
        """Copy one forward's operands into the static buffers."""
        for f in dataclasses.fields(DualDecodeParams):
            getattr(self.p, f.name).copy_(getattr(p, f.name))
        self.enc.copy_(enc)
        self.enc_proj2.copy_(enc_proj2)
        self.tok0.copy_(_tok_proj(self.p, self.sos))
        self.st.bind(self.p)
        return self

    def _reset(self, h0: torch.Tensor) -> None:
        self.st.reset(self.p, h0, self.tok0)

    def _block(self, live: Optional[torch.Tensor] = None) -> None:
        """``k`` masked steps from the static state (the graph's body)."""
        for i in range(self.k):
            _masked_step(self.p, self.cfg, self.enc, self.enc_proj2, self.st,
                         self.logp[i], self.pred[i], live)
        torch.all(self.st.done.reshape(2, self.st.groups, -1), dim=2,
                  out=self.stopped)

    def capture(self) -> "_NoteDecode":
        """Warm the block up eagerly (twice) on a side stream, then capture it
        (``thread_local``: other threads may use the card meanwhile, as the
        server's and the mesh's do)."""
        dev = self.enc.device
        self._reset(torch.zeros_like(self.st.h2[0]))
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(2):
                self._block()
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), _workspaces_in_pool(), torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            self._block()
        self.graph = graph
        self.k2_launches = (self.k * K2.STEP_LAUNCHES
                            if self.st.work is not None else 0)
        return self

    def _replay(self) -> None:
        """A replay, its K2 kernels counted in K2's launches (the capture
        counted none)."""
        self.graph.replay()
        K2.count_launches(self.k2_launches)

    def decode(self, h0: torch.Tensor):
        """One bar from the bar summary ``h0`` (B, 2H). A staff's rows of
        one stop group (``chunk`` rows, ``pick_decode_chunk``; the JAX
        package's chunked decode, here in one loop over the batch) step
        while t < the staff's cap and some item of the group has not
        emitted EOS; their buffers stay zero after. An item's length is its
        last EOS step + 1 (the cap if it never emitted EOS). Returns per
        staff (logp (B, T_s, V), tokens (B, T_s), lengths (B,))."""
        cfg, k = self.cfg, self.k
        caps = tuple(cfg.max_length)
        T = max(caps)
        B, dev = h0.shape[0], h0.device
        self._reset(h0)
        logps = torch.zeros((T,) + self.logp.shape[1:], dtype=self.logp.dtype,
                            device=dev)
        preds = torch.zeros((T, 2, B), dtype=torch.long, device=dev)
        live = (None if self.group is None
                else torch.ones((2, 1), dtype=torch.bool, device=dev))
        on = P.active()
        t = read_ns = 0
        while t < T:
            if self.graph is None:
                self._block(live)
            else:
                self._replay()
            n = min(k, T - t)
            logps[t:t + n] = self.logp[:n]
            preds[t:t + n] = self.pred[:n]
            t += k
            if t >= T:
                break
            if on:
                t0 = time.perf_counter_ns()
            if self.group is None:
                stopped = self.stopped.tolist()
            else:
                left = (~self.st.done).sum(dim=1)
                dist.all_reduce(left, group=self.group)
                live = (left > 0)[:, None]
                stopped = (left == 0)[:, None].tolist()
            if on:
                read_ns += time.perf_counter_ns() - t0
            if not any(t < caps[s] and not d
                       for s in range(2) for d in stopped[s]):
                break
        lengths = self.st.lengths.clone()
        if on:
            g = self.st.groups
            active = sum(int(_stop_step(
                (preds[:cap, s] == cfg.eos).T.reshape(g, B // g, cap)).sum())
                for s, cap in enumerate(caps))
            P.count("note_steps", t)
            if self.graph is not None:
                P.count("graph_steps", t)
            P.count("stop_read_ns", read_ns)
            P.count("rows_computed", 2 * B * t)
            P.count("rows_active", B // g * active)
        return _per_staff(logps, preds, lengths, caps)


def runs_as_graph(enc: torch.Tensor, group=None) -> bool:
    """Whether a greedy forward of ``enc`` runs its note decode captured,
    as replayed CUDA graphs: on a card, without a data-parallel ``group``
    (whose stop read is an all-reduce after every step) and without
    gradients. Elsewhere it runs uncaptured single steps (``_NoteDecode``)."""
    return enc.is_cuda and group is None and not torch.is_grad_enabled()


class _GraphCache:
    """One decoder's captured CUDA graphs, by shape. A copy or a pickle of
    the decoder starts with none."""

    def __init__(self):
        self._by_shape = {}

    def __reduce__(self):
        return type(self), ()


class _NoteGraphs(_GraphCache):
    """One decoder's captured ``_NoteDecode``s, one per shape (rows, stop
    groups, dtype, device, enc's length, K)."""

    def bound(self, p: DualDecodeParams, cfg: ModelConfig,
              enc: torch.Tensor, enc_proj2: torch.Tensor,
              chunk: Optional[int], group=None) -> _NoteDecode:
        """A forward's note decode, holding its operands: where
        ``runs_as_graph``, the captured one of this shape (captured at its
        first use and kept); elsewhere a fresh uncaptured one of single
        steps, kept by no one."""
        if not runs_as_graph(enc, group):
            return _NoteDecode(p, cfg, enc, enc_proj2, chunk, 1, group).bind(
                p, enc, enc_proj2)
        key = (enc.shape[0], enc.shape[0] // chunk if chunk else 1,
               enc.dtype, enc.device, enc.shape[1], GRAPH_STEPS)
        graph = self._by_shape.get(key)
        if graph is not None:
            return graph.bind(p, enc, enc_proj2)
        graph = _NoteDecode(p, cfg, enc, enc_proj2, chunk, GRAPH_STEPS).bind(
            p, enc, enc_proj2).capture()
        self._by_shape[key] = graph
        return graph


def pick_decode_chunk(decode_chunk, batch: int,
                      decode_dtype: Optional[torch.dtype] = None
                      ) -> Optional[int]:
    """The stop group size of a greedy decode of ``batch`` rows, or None
    for one group, by the JAX package's rules (its pick_decode_chunk):
    None, 0 and False mean one group; "auto" means 32 under
    torch.bfloat16 and 16 otherwise; a batch at or under the chunk is one
    group; otherwise the chunk steps down to a divisor of the batch, and a
    result of 1 means one group (24 rows at 16 give 12; 17 give None)."""
    if decode_chunk in (None, 0, False):
        return None
    if decode_chunk == "auto":
        decode_chunk = 32 if decode_dtype == torch.bfloat16 else 16
    chunk = int(decode_chunk)
    if batch <= chunk:
        return None
    while batch % chunk:
        chunk -= 1
    return chunk if chunk > 1 else None


# ---------------------------------------------------------------------------
# Teacher-forced note decoder (training)
# ---------------------------------------------------------------------------

def _stop_step(signal: torch.Tensor) -> torch.Tensor:
    """The reference's early-exit loop's stop step from EOS signals
    (..., B, T) bool: T_stop = max_i(first EOS of item i) + 1, at most T.
    Shape (...)."""
    T = signal.shape[-1]
    first = torch.where(signal.any(dim=-1), signal.int().argmax(dim=-1), T)
    return torch.clamp(first.amax(dim=-1) + 1, max=T)


def _note_lengths(signal: torch.Tensor, max_steps: int,
                  t_stop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-item lengths of the reference's early-exit loop, from a full
    EOS signal (B, T) bool: the loop stops at T_stop (``_stop_step``, or
    ``t_stop``, the global batch's under data parallelism), and an item's
    length is its last EOS step before T_stop, plus one, or ``max_steps``
    if it has none. 1 for an EOS at step 0."""
    T = signal.shape[1]
    steps = torch.arange(T, device=signal.device)
    if t_stop is None:
        t_stop = _stop_step(signal)
    valid = signal & (steps[None, :] < t_stop)
    last = T - 1 - valid.flip(1).int().argmax(dim=1)
    return torch.where(valid.any(dim=1), last + 1, max_steps)


def ga_within_bar(gt: torch.Tensor, dur_frac: torch.Tensor,
                  pad: int) -> torch.Tensor:
    """Within-bar time fraction per token, one duration token per note.

    gt: (..., T) ids; dur_frac: (vocab,) float32 whole-note fraction per
    duration token id (0 elsewhere). Each duration token sits at its
    note's midpoint (cumulative duration minus half its own); pitch and
    separator tokens carry the last duration token's midpoint forward;
    leading ones clamp to the bar start; all over the bar's total.
    Streams that join chord notes each with their own duration token
    double-count here: use ``ga_within_bar_events`` for those.
    """
    valid = (gt != pad).float()
    dur = dur_frac[gt] * valid
    cum = torch.cumsum(dur, dim=-1) - dur / 2.0
    mid = torch.where(dur > 0, cum, -1.0)
    mid = torch.cummax(mid, dim=-1).values.clamp(min=0.0)
    total = dur.sum(dim=-1, keepdim=True).clamp(min=1e-6)
    return (mid / total).clamp(0.0, 1.0)


def ga_within_bar_events(gt: torch.Tensor, dur_frac: torch.Tensor,
                         pad: int, sep: int) -> torch.Tensor:
    """Chord-aware within-bar fraction: time advances once per EVENT (the
    tokens between separators ``sep``) by the event's largest duration,
    and every token of event k sits at event k's midpoint. Vectorised over
    a (..., T, T) same-event mask; trailing pad merges into the last event
    with zero duration."""
    valid = (gt != pad).float()
    dur = dur_frac[gt] * valid
    is_sep = gt == sep
    new_event = torch.cat([torch.ones_like(is_sep[..., :1]),
                           is_sep[..., :-1]], dim=-1)
    seg = torch.cumsum(new_event.int(), dim=-1)                # >= 1
    same = seg[..., :, None] == seg[..., None, :]              # (..., T, T)
    event_dur = torch.where(same, dur[..., None, :], 0.0).amax(dim=-1)
    seg_size = same.sum(dim=-1).clamp(min=1).float()
    per_pos = event_dur / seg_size
    earlier = seg[..., None, :] < seg[..., :, None]
    start = torch.where(earlier, per_pos[..., None, :], 0.0).sum(dim=-1)
    total = per_pos.sum(dim=-1, keepdim=True).clamp(min=1e-6)
    return ((start + event_dur / 2.0) / total).clamp(0.0, 1.0)


def ga_within_bar_auto(gt: torch.Tensor, dur_frac: torch.Tensor, pad: int,
                       sep: int) -> torch.Tensor:
    """Per row: the event map where the row holds a separator, else the
    per-duration-token map."""
    has_sep = (gt == sep).any(dim=-1, keepdim=True)
    return torch.where(has_sep, ga_within_bar_events(gt, dur_frac, pad, sep),
                       ga_within_bar(gt, dur_frac, pad))


def ga_within_bar_map(gt: torch.Tensor, dur_frac: torch.Tensor, pad: int,
                      sep: int, mode: str = "auto") -> torch.Tensor:
    """The within-bar map by ``mode``: 'auto' (per-row dispatch),
    'events' (real-pipeline and chordal targets) or 'tokens' (chord-free
    streams)."""
    if mode == "events":
        return ga_within_bar_events(gt, dur_frac, pad, sep)
    if mode == "tokens":
        return ga_within_bar(gt, dur_frac, pad)
    if mode != "auto":
        raise ValueError(f"ga_map={mode!r}: expected auto|events|tokens")
    return ga_within_bar_auto(gt, dur_frac, pad, sep)


def _embed2(emb2: torch.Tensor, ids2: torch.Tensor) -> torch.Tensor:
    """Per-staff embedding lookup: ids (2, B) -> (2, B, E)."""
    return emb2[torch.arange(2, device=ids2.device)[:, None], ids2]


def _teacher_step(emit_full: bool, enc: torch.Tensor,
                  enc_proj2: torch.Tensor, h2: torch.Tensor,
                  tok2: torch.Tensor, drop2: Optional[torch.Tensor],
                  gt_t: torch.Tensor, guide_t: Optional[torch.Tensor],
                  coin_t: torch.Tensor, *weights: torch.Tensor):
    """One teacher-forced step of both staves: token dropout, attention,
    GRU, head, log-softmax in at least float32, then the next token (the
    ground truth where the staff's coin says so, else the prediction).

    Deterministic in its inputs (the dropout scale ``drop2``, the coins and
    the guide are made by the caller), so the backward's recompute
    (``_teacher_sweep``) gives exactly the forward's values. Every tensor
    it reads is an argument, the stacked staff weights last
    (``_stack_staves``), so the sweep differentiates with respect to all
    of them. Returns (h2, next token embeddings, emitted (2, B[, V]),
    prediction (2, B), guided-attention penalty (2, B) float32 or None).

    With gradients on it runs as that recompute; while tracing it counts
    ``train.recompute_ns`` (its host wall) on the thread that runs the
    sweep (``utils.profiling``). A sweep replayed as a CUDA graph runs no
    Python, so counts nothing.
    """
    recompute = P.active() and torch.is_grad_enabled()
    if recompute:
        t0 = time.perf_counter_ns()
    emb, w_q, v, w_ih, b_ih, w_hh, b_hh, w_out, b_out = weights
    # The dropout scale is float32 (or wider): a bf16 token embedding gets
    # x / 0.9 rounded once, as the JAX package computes it.
    tok = tok2 if drop2 is None else (tok2 * drop2).to(tok2.dtype)
    q2 = torch.bmm(h2, w_q)                                      # (2, B, H)
    energy = torch.tanh(enc_proj2 + q2[:, :, None, :])           # (2,B,T,H)
    scores = torch.einsum("sbth,sh->sbt", energy, v)
    w2 = torch.softmax(scores.to(L.float32_or_wider(scores.dtype)), dim=-1)
    ctx2 = torch.einsum("sbt,bth->sbh", w2.to(enc.dtype), enc)
    x_proj = torch.bmm(torch.cat([tok, ctx2], dim=-1), w_ih) + b_ih[:, None]
    h_proj = torch.bmm(h2, w_hh) + b_hh[:, None]
    h2 = G.gru_gates(x_proj, h_proj, h2)
    out = torch.bmm(torch.cat([h2, ctx2], dim=-1), w_out) + b_out[:, None]
    logp2 = torch.log_softmax(out.to(L.float32_or_wider(out.dtype)), dim=-1)
    pred2 = logp2.argmax(dim=-1)
    nxt = torch.where(coin_t[:, None], gt_t, pred2)
    emitted = (logp2 if emit_full
               else logp2.gather(-1, gt_t[..., None])[..., 0])
    # The attention mass outside the guide, in float32 as the JAX package
    # has it (the guide is zero at pad steps).
    pen = None if guide_t is None else (w2.float() * guide_t).sum(dim=-1)
    nxt = _embed2(emb, nxt)
    if recompute:
        P.count("train.recompute_ns", time.perf_counter_ns() - t0)
    return h2, nxt, emitted, pred2, pen


@dataclasses.dataclass
class _BarOut:
    """A teacher-forced bar's outputs: emitted (T, 2, B[, V]) in at least
    float32, preds (T, 2, B), ga (2, B) float32 (the penalty summed over
    the steps, zero without guides) and, for the backward, each step's
    input state: h2s (T, 2, B, 2H) and toks (T, 2, B, E)."""
    emitted: torch.Tensor
    preds: torch.Tensor
    ga: torch.Tensor
    h2s: torch.Tensor
    toks: torch.Tensor

    @staticmethod
    def empty(emit_full: bool, enc: torch.Tensor, h0: torch.Tensor,
              gt2: torch.Tensor, emb: torch.Tensor) -> "_BarOut":
        _, B, T = gt2.shape
        V, E = emb.shape[1:]
        dev = enc.device

        def new(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=dev)

        return _BarOut(
            new((T, 2, B, V) if emit_full else (T, 2, B),
                L.float32_or_wider(enc.dtype)),
            new((T, 2, B), torch.long), new((2, B), torch.float32),
            new((T, 2) + tuple(h0.shape), h0.dtype),
            new((T, 2, B, E), emb.dtype))

    def clone(self) -> "_BarOut":
        return _BarOut(*(getattr(self, f.name).clone()
                         for f in dataclasses.fields(self)))


def _teacher_loop(emit_full: bool, sos: int, out: _BarOut,
                  enc: torch.Tensor, enc_proj2: torch.Tensor,
                  h0: torch.Tensor, gt2: torch.Tensor,
                  drops: Optional[torch.Tensor], coins: torch.Tensor,
                  guides: Optional[torch.Tensor], *weights: torch.Tensor
                  ) -> None:
    """The bar's T = gt2.shape[2] steps of ``_teacher_step``, both staves
    from the bar summary ``h0`` (B, 2H) and <sos>, written into ``out``:
    each step's emitted log-probs and prediction, the guided-attention
    penalty summed over the steps (``guides`` (T, 2, B, T_enc) or None)
    and each step's input state. ``gt2`` (2, B,
    T) is the ground truth, ``drops`` (T, 2, B, E) the token dropout
    scales or None, ``coins`` (T, 2) the teacher-forcing coins."""
    h2 = torch.stack([h0, h0])
    tok2 = _embed2(weights[0], torch.full_like(gt2[:, :, 0], sos))
    ga = torch.zeros_like(out.ga)
    for t in range(gt2.shape[2]):
        out.h2s[t] = h2
        out.toks[t] = tok2
        h2, tok2, out.emitted[t], out.preds[t], pen = _teacher_step(
            emit_full, enc, enc_proj2, h2, tok2,
            None if drops is None else drops[t], gt2[:, :, t],
            None if guides is None else guides[t], coins[t], *weights)
        if pen is not None:
            ga = ga + pen
    out.ga.copy_(ga)


def _teacher_sweep(emit_full: bool, sos: int, h2s: torch.Tensor,
                   toks: torch.Tensor, g_emit: torch.Tensor,
                   g_ga: torch.Tensor, enc: torch.Tensor,
                   enc_proj2: torch.Tensor, gt2: torch.Tensor,
                   drops: Optional[torch.Tensor], coins: torch.Tensor,
                   guides: Optional[torch.Tensor], *weights: torch.Tensor
                   ) -> list:
    """The backward of ``_teacher_loop``: for t = T-1 .. 0, step t
    recomputed with gradients on from its kept input state (``h2s[t]``,
    ``toks[t]``), then ``torch.autograd.grad`` of its emitted log-probs,
    its penalty (with guides) and, but for the last step, its next state
    and next token embedding, against the gradients carried from step
    t + 1 (``g_emit[t]``, ``g_ga``), with respect to its input state, enc,
    enc_proj2 and the weights. The gradient into the next token runs
    through the embedding gather, the dropout scale and the coin's
    ``where``, as autograd traces an unrolled loop. Returns the gradients
    of (enc, enc_proj2, h0, *weights); the first step's <sos> embedding
    adds its part to the embedding table's."""
    leaves = [x.detach().requires_grad_()
              for x in (enc, enc_proj2) + tuple(weights)]
    sums = [None] * len(leaves)
    g_h = g_tok = None
    with torch.enable_grad():
        for t in reversed(range(gt2.shape[2])):
            h2 = h2s[t].detach().requires_grad_()
            tok2 = toks[t].detach().requires_grad_()
            h2_next, tok_next, emitted, _, pen = _teacher_step(
                emit_full, leaves[0], leaves[1], h2, tok2,
                None if drops is None else drops[t], gt2[:, :, t],
                None if guides is None else guides[t], coins[t],
                *leaves[2:])
            outs, grads_in = [emitted], [g_emit[t]]
            if pen is not None:
                outs.append(pen)
                grads_in.append(g_ga)
            if g_h is not None:
                outs += [h2_next, tok_next]
                grads_in += [g_h, g_tok]
            g_h, g_tok, *parts = torch.autograd.grad(
                outs, [h2, tok2] + leaves, grads_in, allow_unused=True)
            sums = [s if g is None else g if s is None else s + g
                    for s, g in zip(sums, parts)]
    sums = [torch.zeros_like(x) if s is None else s
            for s, x in zip(sums, leaves)]
    sos2 = torch.full_like(gt2[:, :, 0], sos)
    sums[2] = sums[2].index_put(
        (torch.arange(2, device=sos2.device)[:, None], sos2), g_tok,
        accumulate=True)
    return sums[:2] + [g_h[0] + g_h[1]] + sums[2:]


class _TeacherGraph:
    """One shape of a bar's teacher-forced decode with gradients (rows,
    steps, enc's length, dtype, device, ``emit_full``, dropout and guides
    on or off) as two CUDA graphs: the forward's steps (``_teacher_loop``)
    and the backward's sweep (``_teacher_sweep``), captured once and
    replayed for every bar of that shape.

    The graphs read and write only static buffers made here. Before every
    replay the call's operands are copied in (``_bind``; the weights
    change every optimizer step). The sweep writes each gradient over the
    buffer of the operand it belongs to (they have its shape and dtype),
    so the pair holds no buffers of its own for them, only what the next
    bind overwrites. The five bars of a step replay one pair, so each
    replay overwrites the last one's buffers: what the forward returns and
    keeps for its bar, and the gradients the backward returns, are copies
    (autograd may keep a returned gradient as its own buffer, and add the
    next bar's into it).

    Captured in ``thread_local`` mode: the sweep's ``torch.autograd.grad``
    runs its backward ops on autograd's device thread, and they join the
    capture because they go to the capturing stream (autograd runs a
    backward op on its forward op's stream), whatever the thread; the
    mode only decides which threads may not make unsafe calls meanwhile,
    and leaves other threads free to use the card (a process group's
    watchdog, a server's worker), as ``_NoteGraph``'s capture does.
    """

    def __init__(self, emit_full: bool, sos: int, operands: tuple):
        """``operands``: what ``_TeacherBar`` takes, (enc, enc_proj2, h0,
        gt2, drops, coins, guides, *weights)."""
        self.emit_full, self.sos = emit_full, sos
        self.ops = [None if x is None else torch.empty_like(x)
                    for x in operands]
        enc, _, h0, gt2 = self.ops[:4]
        self.out = _BarOut.empty(emit_full, enc, h0, gt2, self.ops[7])
        self.g_emit = torch.empty_like(self.out.emitted)
        self.g_ga = torch.empty_like(self.out.ga)
        self.fwd = self.bwd = None

    @torch.no_grad()
    def _bind(self, operands: tuple) -> None:
        for buf, x in zip(self.ops, operands):
            if buf is not None and x is not None:
                buf.copy_(x)

    def _forward(self) -> None:
        with torch.no_grad():
            _teacher_loop(self.emit_full, self.sos, self.out, *self.ops)

    def _backward(self) -> None:
        enc, enc_proj2, h0, gt2, drops, coins, guides, *weights = self.ops
        grads = _teacher_sweep(self.emit_full, self.sos, self.out.h2s,
                               self.out.toks, self.g_emit, self.g_ga, enc,
                               enc_proj2, gt2, drops, coins, guides, *weights)
        with torch.no_grad():
            for buf, g in zip([enc, enc_proj2, h0] + weights, grads):
                buf.copy_(g)

    def capture(self, operands: tuple) -> "_TeacherGraph":
        """Run both halves eagerly (twice) on a side stream, then capture
        them into one memory pool (the forward's replay and the sweep's
        never overlap: one stream, one step at a time)."""
        dev = self.ops[0].device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(2):
                self._bind(operands)
                self._forward()
                self.g_emit.zero_()
                self.g_ga.zero_()
                self._backward()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), _workspaces_in_pool():
            with torch.cuda.graph(self.fwd, stream=stream,
                                  capture_error_mode="thread_local"):
                self._forward()
            with torch.cuda.graph(self.bwd, pool=self.fwd.pool(),
                                  stream=stream,
                                  capture_error_mode="thread_local"):
                self._backward()
        return self

    def forward(self, operands: tuple) -> _BarOut:
        self._bind(operands)
        self.fwd.replay()
        return self.out.clone()

    def backward(self, h2s: torch.Tensor, toks: torch.Tensor,
                 g_emit: torch.Tensor, g_ga: torch.Tensor,
                 operands: tuple) -> list:
        """The sweep's gradients, as ``_teacher_sweep`` returns them, for
        ``operands`` without h0 (None in its place)."""
        self._bind(operands)
        with torch.no_grad():
            self.out.h2s.copy_(h2s)
            self.out.toks.copy_(toks)
            self.g_emit.copy_(g_emit)
            self.g_ga.copy_(g_ga)
        self.bwd.replay()
        return [x.clone() for x in self.ops[:3] + self.ops[7:]]


class _TeacherBar(torch.autograd.Function):
    """A bar's teacher-forced note decode with gradients, as one autograd
    node: apply(graph, emit_full, sos, enc, enc_proj2, h0, gt2, drops,
    coins, guides, *weights) -> (emitted (T, 2, B[, V]), preds (T, 2, B),
    ga (2, B)), as ``_teacher_loop`` computes them.

    The forward runs the T steps without autograd and keeps each step's
    input state (``h2s``, ``toks``: 2 x B x (2H + E) numbers a step); the
    backward recomputes and differentiates them one step at a time from
    the last (``_teacher_sweep``), so a step's activations, its (2, B,
    T_enc, H) attention energies included, live only while it is swept.
    With ``graph`` (a captured ``_TeacherGraph`` of this shape) both
    halves are its replays; without, they run eagerly (the CPU), the same
    code the graphs hold. Guided attention (``guides``) runs inside the
    graphs too. No collective: under data parallelism the operands are
    this rank's rows (the dropout scales cut from the global batch's by
    the caller) and the gradients are summed over the ranks after the
    backward.

    While tracing, each half counts on the innermost open span of its
    thread (or as a bare count; autograd's device thread has no span on a
    card): ``teacher_steps`` (the steps it ran, T) and
    ``teacher_graph_steps`` (those it ran inside a replay).
    """

    @staticmethod
    def forward(ctx, graph, emit_full, sos, *operands):
        enc, enc_proj2, h0, gt2, drops, coins, guides, *weights = operands
        if graph is None:
            out = _BarOut.empty(emit_full, enc, h0, gt2, weights[0])
            _teacher_loop(emit_full, sos, out, *operands)
        else:
            out = graph.forward(operands)
        _count_teacher_steps(gt2.shape[2], graph)
        ctx.graph, ctx.emit_full, ctx.sos = graph, emit_full, sos
        ctx.save_for_backward(out.h2s, out.toks, enc, enc_proj2, gt2, drops,
                              coins, guides, *weights)
        ctx.mark_non_differentiable(out.preds)
        if guides is None:
            ctx.mark_non_differentiable(out.ga)
        return out.emitted, out.preds, out.ga

    @staticmethod
    def backward(ctx, g_emit, _, g_ga):
        h2s, toks, enc, enc_proj2, gt2, drops, coins, guides, *weights = \
            ctx.saved_tensors
        graph = ctx.graph
        if graph is None:
            grads = _teacher_sweep(ctx.emit_full, ctx.sos, h2s, toks, g_emit,
                                   g_ga, enc, enc_proj2, gt2, drops, coins,
                                   guides, *weights)
        else:
            grads = graph.backward(h2s, toks, g_emit, g_ga, (
                enc, enc_proj2, None, gt2, drops, coins, guides, *weights))
        _count_teacher_steps(gt2.shape[2], graph)
        g_enc, g_enc_proj2, g_h0, *g_weights = grads
        return (None, None, None, g_enc, g_enc_proj2, g_h0, None, None, None,
                None, *g_weights)


def _count_teacher_steps(steps: int, graph) -> None:
    P.count("teacher_steps", steps)
    if graph is not None:
        P.count("teacher_graph_steps", steps)


def teacher_runs_as_graph(enc: torch.Tensor) -> bool:
    """Whether a teacher-forced bar of ``enc`` runs as replayed CUDA graphs
    (``_TeacherGraph``): on a card, with gradients on (data parallelism
    included: the bar runs no collective). Without gradients the bar is
    the plain loop, on every device."""
    return enc.is_cuda and torch.is_grad_enabled()


class _TeacherGraphs(_GraphCache):
    """One decoder's ``_TeacherGraph``s, captured once per shape."""

    def bound(self, emit_full: bool, sos: int,
              operands: tuple) -> _TeacherGraph:
        """The graph pair of these operands' shape, captured at its first
        use."""
        enc, _, _, gt2, drops, _, guides = operands[:7]
        key = (emit_full, sos, tuple(enc.shape), enc.dtype, enc.device,
               tuple(gt2.shape), drops is None, guides is None)
        graph = self._by_shape.get(key)
        if graph is None:
            graph = _TeacherGraph(emit_full, sos, operands).capture(operands)
            self._by_shape[key] = graph
        return graph


def note_decoder_dual_scan(weights: tuple, cfg: ModelConfig,
                           enc: torch.Tensor, enc_proj2: torch.Tensor,
                           h0: torch.Tensor, gt_up: torch.Tensor,
                           gt_low: torch.Tensor, lengths2: torch.Tensor,
                           tf_ratio: float, train: bool,
                           generator: Optional[torch.Generator] = None,
                           emit_full: bool = True, ga_frac=None,
                           ga_sigma: float = 0.15,
                           ga_dur_frac: Optional[torch.Tensor] = None,
                           ga_content: Optional[torch.Tensor] = None,
                           ga_map: str = "auto", group=None,
                           rows: Optional[Tuple[int, int]] = None,
                           graphs: Optional["_TeacherGraphs"] = None):
    """Teacher-forced decode of one bar, both staves in one loop of
    max(T_up, T_low) steps, each staff's cap T_s the width of its ground
    truth ``gt_up`` (B, T_up) and ``gt_low`` (B, T_low); the narrower
    staff's ground truth is padded with <pad> and each staff's outputs are
    cut back to its own cap. ``weights`` is ``_stack_staves`` of the two
    note decoders.

    One teacher-forcing coin per staff per step, shared across the batch.
    emit_full=False emits only the log-prob of the ground-truth token
    ((B, T) per staff instead of (B, T, V)). ``lengths2`` (2, B) are the
    staves' lengths (``_note_lengths`` of the ground truth).

    With gradients on, the bar is one autograd node (``_TeacherBar``): its
    forward keeps each step's input state and no activation, and its
    backward recomputes the steps one at a time from the last, (2, B,
    T_enc, H) attention energies included. On a card (CUDA tensors) both
    halves replay CUDA graphs captured at a shape's first bar and kept in
    ``graphs`` (the decoder's); the graphs' buffers are shared, so one
    training step at a time per decoder. Without gradients the steps run
    as a plain loop. The steps' dropout scales and coins are drawn here,
    before the steps, so the recompute sees the same ones.

    ga_frac=(bar_start, bar_span) turns on the guided-attention penalty:
    step t is expected to attend at bar_start + bar_span * within(t) of
    the encoder frames (within from ``ga_dur_frac`` by ``ga_map``, else
    the token index over the length), compressed by ``ga_content`` (B,),
    and the penalty is the attention mass outside a Gaussian of width
    ``ga_sigma`` around it, summed over non-pad steps. The guide takes no
    gradient and is computed for all steps at once. Returns ((up_logp,
    up_tok), (low_logp, low_tok), ga_num (2, B) float32 or None).
    ``group``: the token dropout masks are this rank's rows of the global
    batch's, at ``rows`` (the coins are per step, shared by the batch).
    """
    B, dev = enc.shape[0], enc.device
    t_up, t_low = gt_up.shape[1], gt_low.shape[1]
    T = max(t_up, t_low)
    gt2 = torch.stack([F.pad(gt_up, (0, T - t_up), value=cfg.pad),
                       F.pad(gt_low, (0, T - t_low), value=cfg.pad)]).long()
    emb = weights[0]
    drops = None
    if train:
        drops = _dropout(torch.ones((T, 2, B, emb.shape[-1]), device=dev,
                                    dtype=L.float32_or_wider(emb.dtype)),
                         0.1, train, generator, group, axis=2, rows=rows)
    coins = torch.rand((T, 2), generator=generator, device=dev) < tf_ratio
    guides = None
    if ga_frac is not None:
        n_enc = enc.shape[1]
        f_frac = torch.arange(n_enc, dtype=torch.float32, device=dev) / n_enc
        if ga_dur_frac is not None:
            within = ga_within_bar_map(gt2, ga_dur_frac, cfg.pad,
                                       cfg.newline, ga_map)
        else:
            steps = torch.arange(T, dtype=torch.float32, device=dev)
            within = ((steps[None, None, :] + 0.5)
                      / lengths2.float().clamp(min=1.0)[..., None]
                      ).clamp(max=1.0)
        bar_start, bar_span = ga_frac
        phi = bar_start + bar_span * within                      # (2, B, T)
        if ga_content is not None:
            phi = phi * ga_content[None, :, None]
        phi = phi.permute(2, 0, 1)                               # (T, 2, B)
        guides = 1.0 - torch.exp(-((f_frac - phi[..., None]) ** 2)
                                 / (2.0 * ga_sigma ** 2))  # (T, 2, B, T_enc)
        guides = guides * (gt2 != cfg.pad).permute(2, 0, 1)[..., None]

    operands = (enc, enc_proj2, h0, gt2, drops, coins, guides) + tuple(weights)
    if torch.is_grad_enabled():
        graph = (graphs.bound(emit_full, cfg.sos, operands)
                 if graphs is not None and teacher_runs_as_graph(enc)
                 else None)
        logps, toks, ga = _TeacherBar.apply(graph, emit_full, cfg.sos,
                                            *operands)
    else:
        out = _BarOut.empty(emit_full, enc, h0, gt2, emb)
        _teacher_loop(emit_full, cfg.sos, out, *operands)
        logps, toks, ga = out.emitted, out.preds, out.ga
    up = (logps[:t_up, 0].transpose(0, 1), toks[:t_up, 0].transpose(0, 1))
    low = (logps[:t_low, 1].transpose(0, 1),
           toks[:t_low, 1].transpose(0, 1))
    return up, low, (ga if guides is not None else None)


# ---------------------------------------------------------------------------
# Hierarchical (bar-level) decoder
# ---------------------------------------------------------------------------

def _mlp(cfg: ModelConfig, out_dim: int) -> nn.Sequential:
    h = cfg.hidden_size
    return nn.Sequential(nn.Linear(4 * h, 4 * h), nn.ReLU(),
                         nn.Linear(4 * h, 2 * h), nn.ReLU(),
                         nn.Linear(2 * h, out_dim))


class HierarchicalDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.note_emb = nn.Embedding(cfg.vocab_size, cfg.note_emb_size)
        self.time_sig_emb = nn.Embedding(cfg.num_time_sig + 1,
                                         cfg.time_sig_emb_size)
        self.key_emb = nn.Embedding(cfg.num_keys + 1, cfg.key_emb_size)
        self.staff_emb = nn.GRU(cfg.note_emb_size, cfg.staff_emb_size,
                                bidirectional=True, batch_first=True)
        self.attn = A.Attention(h)
        self.gru = nn.GRU(cfg.bar_gru_in, 2 * h)
        self.time_sig_out = _mlp(cfg, cfg.num_time_sig)
        self.key_out = _mlp(cfg, cfg.num_keys)
        self.upper_decoder = NoteDecoder(cfg)
        self.lower_decoder = NoteDecoder(cfg)
        self._note_graphs = _NoteGraphs()
        self._teacher_graphs = _TeacherGraphs()

    def staff_summaries(self, tokens: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
        """S staff summaries in one call: tokens (S, B, T), lengths (S, B),
        each in [1, T] -> (S, B, 2 * staff_emb_size). K3 where ``uses_k3``
        holds (the lengths moved to the tokens' card, never read back),
        else one packed GRU call. Counts ``summary_rows`` (S x B) and
        ``summary_kernel_rows`` (those K3 computed) on the enclosing span
        (``forward/decoder``)."""
        rows = tokens.shape[0] * tokens.shape[1]
        kernel = uses_k3(tokens, self.note_emb, self.staff_emb)
        P.count("summary_rows", rows)
        P.count("summary_kernel_rows", rows if kernel else 0)
        if kernel:
            return K3.staff_summary_cuda(self.staff_emb, self.note_emb.weight,
                                         tokens, lengths.to(tokens.device))
        return G.bidir_final_fused(self.staff_emb,
                                   L.embed(self.note_emb.weight, tokens),
                                   lengths)

    def sos_token(self, B: int, dev: torch.device) -> torch.Tensor:
        """The first bar's conditioning token: the staff summary of
        [<sos>, <eos>] for both staves, plus the SOS time- and
        key-signature embeddings."""
        cfg = self.cfg
        sos_pair = torch.full((1, B, 2), cfg.eos, dtype=torch.long,
                              device=dev)
        sos_pair[..., 0] = cfg.sos
        staff0 = self.staff_summaries(
            sos_pair, torch.full((1, B), 2, dtype=torch.long, device=dev))[0]
        time0 = self.time_sig_emb.weight[cfg.num_time_sig].expand(B, -1)
        key0 = self.key_emb.weight[cfg.num_keys].expand(B, -1)
        return torch.cat([staff0, staff0, time0, key0], dim=-1)

    def _note_operands(self, enc: torch.Tensor,
                       decode_dtype: Optional[torch.dtype]):
        """The note decoders' encoder operands: (enc, both staves' attention
        projections (2, B, T, H)), computed from the float32 ``enc`` and
        cast to ``decode_dtype`` if given."""
        enc_proj2 = torch.stack([
            A.precompute_enc_proj(self.upper_decoder.attn, enc),
            A.precompute_enc_proj(self.lower_decoder.attn, enc)])
        return _cast(enc, decode_dtype), _cast(enc_proj2, decode_dtype)

    def forward(self, enc: torch.Tensor, hidden: torch.Tensor,
                decode_dtype: Optional[torch.dtype] = None, group=None,
                decode_chunk=None):
        """Greedy decode of max_bars bars (no ground truth).

        Returns (time_sig_logp (B, bars, 7), key_logp (B, bars, 14),
        upper_logp (B, bars, Tu, V), lower_logp (B, bars, Tl, V), aux) with
        aux holding per-bar tokens (B, bars, T_s) and lengths (B, bars).

        ``decode_dtype`` (bf16 decode): the note decoders' loop runs on
        copies of enc, of its attention projections, of the bar summary
        and of the staves' weights in that dtype; their softmaxes and
        log-softmaxes, and the emitted log-probs, stay float32. The bar
        level (attention, GRU, heads, staff summaries) stays float32.
        ``group``: the note decoders stop on every rank's items
        (``_NoteDecode``). ``decode_chunk`` (None, an int or
        "auto"; ``pick_decode_chunk`` against B): the note decoders stop
        in groups of that many rows; ignored under ``group``, as the JAX
        package ignores it under a mesh.

        The note decoders run one loop, ``_NoteDecode``, from
        ``_NoteGraphs.bound``: on a card, without ``group`` and without
        gradients, as replayed CUDA graphs (captured at a shape's first
        forward and kept on this module); otherwise one uncaptured step at
        a time. Both give the same outputs.

        Each bar's note decoders run in a span ``decode/notes``
        (``utils.profiling``; a record, no kineto range).
        """
        cfg = self.cfg
        B, dev = enc.shape[0], enc.device
        chunk = (None if group is not None
                 else pick_decode_chunk(decode_chunk, B, decode_dtype))
        enc_proj_bar = A.precompute_enc_proj(self.attn, enc)
        enc_dec, enc_proj2 = self._note_operands(enc, decode_dtype)
        dual = dual_decode_params(self.upper_decoder, self.lower_decoder,
                                  cfg, decode_dtype)
        notes = self._note_graphs.bound(dual, cfg, enc_dec, enc_proj2, chunk,
                                        group)

        token = self.sos_token(B, dev)
        t_s = max(cfg.max_length)
        outs = []
        for _ in range(cfg.max_bars):
            context, _ = A.attention_step(self.attn, enc_proj_bar, enc,
                                          hidden)
            bar_summary = G.gru_step(self.gru,
                                     torch.cat([token, context], dim=-1),
                                     hidden)
            hidden = bar_summary
            with P.span("decode/notes", ranged=False):
                (up_logp, up_tok, up_len), (low_logp, low_tok, low_len) = \
                    notes.decode(bar_summary.to(enc_dec.dtype))
            head_in = torch.cat([bar_summary, context], dim=-1)
            ts_logp = torch.log_softmax(self.time_sig_out(head_in), dim=-1)
            key_logp = torch.log_softmax(self.key_out(head_in), dim=-1)

            def pad_t(a):
                return F.pad(a, (0, t_s - a.shape[1]), value=cfg.pad)

            sums = self.staff_summaries(
                torch.stack([pad_t(up_tok), pad_t(low_tok)]),
                torch.stack([up_len, low_len]))
            token = torch.cat([
                sums[0], sums[1],
                self.time_sig_emb(ts_logp.argmax(dim=-1)),
                self.key_emb(key_logp.argmax(dim=-1))], dim=-1)
            outs.append((ts_logp, key_logp, up_logp, low_logp, up_tok,
                         low_tok, up_len, low_len))

        (ts_logp, key_logp, up_logp, low_logp, up_tok, low_tok, up_len,
         low_len) = (torch.stack(x, dim=1) for x in zip(*outs))
        aux = {"upper_tokens": up_tok, "lower_tokens": low_tok,
               "upper_lengths": up_len, "lower_lengths": low_len}
        return ts_logp, key_logp, up_logp, low_logp, aux

    def forward_teacher_forced(self, enc: torch.Tensor,
                               hidden: torch.Tensor, ground_truth,
                               tf_ratio: float, train: bool,
                               generator: Optional[torch.Generator] = None,
                               emit_full: bool = True,
                               ga_sigma: float = 0.0, ga_dur_frac=None,
                               ga_content: Optional[torch.Tensor] = None,
                               ga_map: str = "auto",
                               decode_dtype: Optional[torch.dtype] = None,
                               group=None,
                               rows: Optional[Tuple[int, int]] = None):
        """Decode max_bars bars against ``ground_truth`` = (time_sig
        (B, bars), key (B, bars), upper (B, bars, Tu), upper_len (B, bars),
        lower (B, bars, Tl), lower_len (B, bars)).

        Per bar: dropout 0.1 on the conditioning token (train only), the
        bar GRU step, the teacher-forced note decode of both staves, the
        heads, then the next conditioning token from the four staff
        summaries (predicted and ground-truth, upper and lower) in one
        packed call, chosen by one teacher-forcing coin per bar. Returns
        the greedy forward's outputs; with emit_full=False the staff
        outputs are the log-probs at the ground-truth tokens (B, bars, T).
        ga_sigma > 0 in training turns on the guided-attention penalty
        (see note_decoder_dual_scan): aux["ga_num"] (B, bars, 2).
        ``decode_dtype`` casts the note decoders' operands as the greedy
        forward does; the emitted log-probs stay float32.

        The staves' lengths come from the ground truth's EOS (coupled
        across the batch) and reach the host once per call, for the
        packed summaries; every length must be at least 1.

        Each staff decodes to its ground truth's width, at most
        cfg.max_length: a batch whose targets end early may be cut to a
        shorter width (length bucketing). The cut-off positions are all
        <pad>, so the loss and its gradients are those of the full width.

        ``group`` (data parallelism, this rank's rows): the stop steps
        behind the lengths and the length check are the global batch's,
        from one all-reduce, so every rank raises or none does; dropout
        masks are this rank's rows of the global ones, at ``rows``.

        With gradients on, each bar's note decoders are one autograd node
        (``_TeacherBar``); on a card its forward and backward replay CUDA
        graphs captured at a shape's first bar and kept on this module
        (``_TeacherGraph``), whose buffers every bar of that shape shares:
        one training step at a time per model instance.
        """
        cfg = self.cfg
        B, dev = enc.shape[0], enc.device
        ts_gt, key_gt, up_gt, up_len_gt, low_gt, low_len_gt = [
            torch.as_tensor(g, device=dev).long() for g in ground_truth]
        bars = cfg.max_bars
        t_up, t_low = up_gt.shape[-1], low_gt.shape[-1]
        if t_up > cfg.max_length[0] or t_low > cfg.max_length[1]:
            raise ValueError(f"ground truth widths ({t_up}, {t_low}) exceed "
                             f"max_length {tuple(cfg.max_length)}")
        enc_proj_bar = A.precompute_enc_proj(self.attn, enc)
        enc_dec, enc_proj2 = self._note_operands(enc, decode_dtype)
        dual = _stack_staves(self.upper_decoder, self.lower_decoder,
                             decode_dtype)
        use_ga = ga_sigma > 0 and train
        if use_ga and ga_dur_frac is not None:
            ga_dur_frac = torch.as_tensor(ga_dur_frac, dtype=torch.float32,
                                          device=dev)

        up_sig, low_sig = (up_gt.transpose(0, 1) == cfg.eos,
                           low_gt.transpose(0, 1) == cfg.eos)  # (bars, B, T)
        stops = torch.stack([_stop_step(up_sig), _stop_step(low_sig)])
        gt_short = False
        if group is not None:
            # The global stop steps, and whether any rank holds a target
            # length below 1, in one all-reduce (max).
            short = torch.minimum(up_len_gt.min(), low_len_gt.min()) < 1
            red = torch.cat([stops.reshape(-1),
                             short.to(stops.dtype).reshape(1)])
            dist.all_reduce(red, op=dist.ReduceOp.MAX, group=group)
            stops, gt_short = red[:-1].reshape(stops.shape), bool(red[-1])
        up_len = torch.stack([_note_lengths(up_sig[j], t_up, stops[0, j])
                              for j in range(bars)])          # (bars, B)
        low_len = torch.stack([_note_lengths(low_sig[j], t_low, stops[1, j])
                               for j in range(bars)])
        lens_host = torch.stack([up_len, low_len, up_len_gt.T,
                                 low_len_gt.T], dim=1).cpu()  # (bars, 4, B)
        if gt_short or bool((lens_host < 1).any()):
            raise ValueError("every staff length must be at least 1 (the "
                             "packed staff summaries take no empty "
                             "sequence)")

        t_s = max(t_up, t_low)

        def pad_t(a):
            return F.pad(a, (0, t_s - a.shape[1]), value=cfg.pad)

        token = self.sos_token(B, dev)
        outs = []
        for j in range(bars):
            token = _dropout(token, 0.1, train, generator, group, rows=rows)
            context, _ = A.attention_step(self.attn, enc_proj_bar, enc,
                                          hidden)
            bar_summary = G.gru_step(self.gru,
                                     torch.cat([token, context], dim=-1),
                                     hidden)
            hidden = bar_summary
            (up_logp, up_tok), (low_logp, low_tok), ga_num = \
                note_decoder_dual_scan(
                    dual, cfg, enc_dec, enc_proj2,
                    bar_summary.to(enc_dec.dtype), up_gt[:, j],
                    low_gt[:, j], torch.stack([up_len[j], low_len[j]]),
                    tf_ratio, train, generator, emit_full=emit_full,
                    ga_frac=(j / bars, 1.0 / bars) if use_ga else None,
                    ga_sigma=ga_sigma, ga_dur_frac=ga_dur_frac,
                    ga_content=ga_content, ga_map=ga_map, group=group,
                    rows=rows, graphs=self._teacher_graphs)
            head_in = torch.cat([bar_summary, context], dim=-1)
            ts_logp = torch.log_softmax(self.time_sig_out(head_in), dim=-1)
            key_logp = torch.log_softmax(self.key_out(head_in), dim=-1)

            sums = self.staff_summaries(
                torch.stack([pad_t(up_tok), pad_t(low_tok),
                             pad_t(up_gt[:, j]), pad_t(low_gt[:, j])]),
                lens_host[j])
            token_pred = torch.cat([
                sums[0], sums[1],
                self.time_sig_emb(ts_logp.argmax(dim=-1)),
                self.key_emb(key_logp.argmax(dim=-1))], dim=-1)
            token_gt = torch.cat([
                sums[2], sums[3], self.time_sig_emb(ts_gt[:, j]),
                self.key_emb(key_gt[:, j])], dim=-1)
            coin = torch.rand((), generator=generator, device=dev) < tf_ratio
            token = torch.where(coin, token_gt, token_pred)
            outs.append((ts_logp, key_logp, up_logp, low_logp, up_tok,
                         low_tok) + ((ga_num,) if use_ga else ()))

        stacked = [torch.stack(x, dim=1) for x in zip(*outs)]
        ts_logp, key_logp, up_logp, low_logp, up_tok, low_tok = stacked[:6]
        aux = {"upper_tokens": up_tok, "lower_tokens": low_tok,
               "upper_lengths": up_len.T, "lower_lengths": low_len.T}
        if use_ga:
            # (2, bars, B) -> (B, bars, 2): per clip, bar and staff.
            aux["ga_num"] = stacked[6].permute(2, 1, 0)
        return ts_logp, key_logp, up_logp, low_logp, aux


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class ScoreTranscription(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.convstack = ConvStack(cfg)
        self.encoder = Encoder(cfg)
        self.decoder = HierarchicalDecoder(cfg)

    def encode(self, spectrogram: torch.Tensor):
        """(B, 1, T, F) -> (enc (B, T, 2H), bridge hidden (B, 2H)), in the
        spans ``forward/convstack`` and ``forward/encoder`` (records, no
        kineto ranges)."""
        with P.span("forward/convstack", ranged=False):
            feats = self.convstack(spectrogram)
        with P.span("forward/encoder", ranged=False):
            return self.encoder(feats.to(L.float32_or_wider(feats.dtype)))

    def forward(self, spectrogram: torch.Tensor, train: bool = False,
                ground_truth=None, tf_ratio: float = 0.0,
                emit_full: bool = True,
                sample_weight: Optional[torch.Tensor] = None,
                ga_sigma: float = 0.0, ga_dur_frac=None,
                ga_content: Optional[torch.Tensor] = None,
                ga_map: str = "auto",
                conv_dtype: Optional[torch.dtype] = None,
                decode_dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None, group=None,
                rows: Optional[Tuple[int, int]] = None, decode_chunk=None,
                counted: Optional[torch.Tensor] = None):
        """spectrogram (B, 1, T, F) -> (time_sig_logp, key_logp,
        upper_logp, lower_logp, aux).

        Without ground truth: greedy inference (deterministic, no
        gradient; ``train`` must be False). With ground truth: the
        teacher-forced forward (HierarchicalDecoder.forward_teacher_forced),
        with gradients. train=True runs the ConvStack on batch statistics
        (weighted by ``sample_weight``; the BatchNorm running buffers are
        written in place), dropout drawn from ``generator`` and the
        guided-attention penalty; train=False folds the running statistics
        and drops nothing.

        Reduced precision, as the JAX package's forward has it:
        ``decode_dtype`` (e.g. torch.bfloat16) runs the note decoders' loop
        on operands of that dtype and, when not training, the ConvStack on
        the spectrogram cast to it (BN folded in float32, then cast).
        ``conv_dtype`` (training only) runs the ConvStack in that dtype
        (``ConvStack.forward_train``'s compute_dtype). The encoder always
        takes float32 (or wider) features.

        ``group`` (data parallelism): the batch is this rank's rows of the
        global batch, and the batch-coupled parts (BatchNorm statistics,
        dropout masks, stop steps) are the global batch's; see the module
        docstring. ``rows`` = (start, total): the batch is the rows [start,
        start + B) of a global batch of ``total`` (default: this rank's
        equal share); it places the rank's dropout masks. ``counted``
        (B,) 0/1 (training): the rows the BatchNorm statistics count when
        every row weight is 0; 0 marks a rank's stand-in row
        (``parallel.step_rows``); default all.

        ``decode_chunk`` (greedy inference only; None, an int or "auto"):
        the note decoders stop in groups of that many rows
        (HierarchicalDecoder.forward), the JAX package's decode_chunk.
        """
        if ground_truth is None:
            if train:
                raise ValueError("the training forward needs ground_truth")
            return self._greedy(spectrogram, decode_dtype, group,
                                decode_chunk)
        with P.span("forward/convstack"):
            if train:
                feats = self.convstack.forward_train(
                    spectrogram, sample_weight, generator, conv_dtype, group,
                    rows, counted)
            else:
                feats = self.convstack(_cast(spectrogram, decode_dtype))
        with P.span("forward/encoder"):
            enc, hidden = self.encoder(
                feats.to(L.float32_or_wider(feats.dtype)))
        with P.span("forward/decoder"):
            return self.decoder.forward_teacher_forced(
                enc, hidden, ground_truth, tf_ratio, train, generator,
                emit_full=emit_full, ga_sigma=ga_sigma,
                ga_dur_frac=ga_dur_frac, ga_content=ga_content,
                ga_map=ga_map, decode_dtype=decode_dtype, group=group,
                rows=rows)

    @torch.no_grad()
    def _greedy(self, spectrogram: torch.Tensor,
                decode_dtype: Optional[torch.dtype] = None, group=None,
                decode_chunk=None):
        enc, hidden = self.encode(_cast(spectrogram, decode_dtype))
        with P.span("forward/decoder", ranged=False):
            return self.decoder(enc, hidden, decode_dtype, group,
                                decode_chunk)
