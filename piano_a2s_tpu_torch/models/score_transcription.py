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
         decode greedily or, given ground truth, teacher-forced; MLP heads
         give time and key signature.

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
rank's items have stopped. So N ranks compute what one rank computes on
the joined rows, as the JAX package's one program over a device mesh
does. Serving shards (infer.Transcriber(use_mesh=True)) pass no group:
each stops on its own.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import attention as A
from ..ops import gru as G
from ..ops import layers as L
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


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_size
        self.gru = nn.GRU(cfg.conv_feature_size, h, num_layers=2,
                          bidirectional=True, batch_first=True)
        self.fc = nn.Linear(2 * h, h)

    def forward(self, x: torch.Tensor):
        """x (B, T, F_in) -> (enc (B, T, 2H), bridge hidden (B, 2H)).

        Bridge: per layer tanh(fc([h_fwd; h_bwd])), the two layers
        concatenated.
        """
        enc, h_n = self.gru(x)  # h_n: (l0 fwd, l0 bwd, l1 fwd, l1 bwd)
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


def note_decoder_dual_infer(p: DualDecodeParams, cfg: ModelConfig,
                            enc: torch.Tensor, enc_proj2: torch.Tensor,
                            h0: torch.Tensor, group=None,
                            chunk: Optional[int] = None):
    """Greedy decode of both staves with the reference's early exit.

    Staff s steps while t < its cap and not every batch item has emitted
    EOS; its buffers stay zero after it stops. An item's length is its
    last EOS step + 1 (the cap if it never emitted EOS). The loop reads
    the stop condition on the host every step. Under ``group`` (eval under
    data parallelism) "every batch item" is every rank's: the count of
    items still decoding is all-reduced each step, so all ranks stop at
    the same step, as the JAX package's one loop over the global batch.

    ``chunk`` (a divisor of B; ``pick_decode_chunk``; None under
    ``group``) makes each run of ``chunk`` rows a stop group of its own: a staff's rows of one group
    step until every item of that group has emitted EOS, and their buffers
    stay zero after. This is the JAX package's chunked decode (one decode
    loop per group), in one loop over the whole batch: the loop ends when
    no group of either staff is active, the step at which the slowest
    group stops, and the host reads a (2, groups) flag a step.

    Returns per staff (logp (B, T_s, V), tokens (B, T_s), lengths (B,)).

    While tracing (``utils.profiling``), the call counts on the innermost
    open span (``decode/notes``): ``note_steps`` (steps run),
    ``stop_read_ns`` (the host's wall in the stop reads), ``rows_computed``
    (2 x B a step: both staves' rows are always stepped) and
    ``rows_active`` (the rows of the (staff, group) pairs still decoding).
    """
    B, dev = enc.shape[0], enc.device
    caps = tuple(cfg.max_length)
    T = max(caps)
    n_groups = B // chunk if chunk else 1
    logps = torch.zeros((T, 2, B, cfg.vocab_size),
                        dtype=L.float32_or_wider(enc.dtype), device=dev)
    preds = torch.zeros((T, 2, B), dtype=torch.long, device=dev)
    done = torch.zeros((2, B), dtype=torch.bool, device=dev)
    lengths = torch.tensor(caps, device=dev)[:, None].repeat(1, B)
    h2 = torch.stack([h0, h0])
    tok2 = _tok_proj(p, torch.full((2, B), cfg.sos, dtype=torch.long,
                                   device=dev))
    masks = {}
    on = P.active()
    steps = read_ns = active_groups = 0
    for t in range(T):
        if on:
            t0 = time.perf_counter_ns()
        if group is None:
            group_done = done.reshape(2, n_groups, -1).all(dim=2).tolist()
        else:
            left = (~done).sum(dim=1)
            dist.all_reduce(left, group=group)
            group_done = (left == 0)[:, None].tolist()
        if on:
            read_ns += time.perf_counter_ns() - t0
        act = tuple(tuple(t < caps[s] and not d for d in group_done[s])
                    for s in range(2))
        if not any(map(any, act)):
            break
        if on:
            steps += 1
            active_groups += sum(map(sum, act))
        if act not in masks:
            masks[act] = torch.tensor(act, device=dev).repeat_interleave(
                B // n_groups, dim=1)                            # (2, B)
        m = masks[act]
        h2_new, logp2, pred2 = _fast_step(p, enc, enc_proj2, h2, tok2)
        h2 = torch.where(m[:, :, None], h2_new, h2)
        logps[t] = torch.where(m[:, :, None], logp2, 0.0)
        preds[t] = torch.where(m, pred2, 0)
        is_eos = (pred2 == cfg.eos) & m
        lengths = torch.where(is_eos, t + 1, lengths)
        done = done | is_eos
        tok2 = torch.where(m[:, :, None], _tok_proj(p, pred2), tok2)
    if on:
        P.count("note_steps", steps)
        P.count("stop_read_ns", read_ns)
        P.count("rows_computed", 2 * B * steps)
        P.count("rows_active", B // n_groups * active_groups)
    out = []
    for s, cap in enumerate(caps):
        out.append((logps[:cap, s].transpose(0, 1),
                    preds[:cap, s].transpose(0, 1), lengths[s]))
    return tuple(out)


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
    the guide are made by the caller), so a checkpointed call recomputes
    it exactly. Every tensor it reads is an argument, the stacked staff
    weights last (``_stack_staves``), so the reentrant checkpoint passes
    gradients to all of them. Returns (h2, next token embeddings, emitted
    (2, B[, V]), prediction (2, B), guided-attention penalty (2, B) float32
    or None).

    With gradients on it runs as the reentrant checkpoint's recompute, in
    the backward, on the thread autograd runs it on; while tracing it
    counts ``train.recompute_ns`` (its host wall) there
    (``utils.profiling``).
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
                           rows: Optional[Tuple[int, int]] = None):
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

    With gradients on, each step runs under a reentrant activation
    checkpoint: the forward keeps no activations (it runs without autograd)
    and the backward recomputes the step, (2, B, T_enc, H) attention
    energies included. The steps' dropout scales and coins are drawn here,
    before the checkpointed function, so the recompute sees the same ones.

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
    tok2 = _embed2(weights[0], torch.full((2, B), cfg.sos, dtype=torch.long,
                                          device=dev))
    drops = None
    if train:
        drops = _dropout(torch.ones((T,) + tok2.shape, device=dev,
                                    dtype=L.float32_or_wider(tok2.dtype)),
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

    h2 = torch.stack([h0, h0])
    ga = torch.zeros((2, B), dtype=torch.float32, device=dev)
    emitted, preds = [], []
    for t in range(T):
        args = (emit_full, enc, enc_proj2, h2, tok2,
                None if drops is None else drops[t], gt2[:, :, t],
                None if guides is None else guides[t], coins[t]) + weights
        if torch.is_grad_enabled():
            outs = checkpoint(_teacher_step, *args, use_reentrant=True,
                              preserve_rng_state=False)
        else:
            outs = _teacher_step(*args)
        h2, tok2, e, pred2, pen = outs
        if pen is not None:
            ga = ga + pen
        emitted.append(e)
        preds.append(pred2)
    logps = torch.stack(emitted)                      # (T, 2, B[, V])
    toks = torch.stack(preds)                         # (T, 2, B)
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

    def staff_summaries(self, tokens: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
        """S staff summaries in one packed GRU call: tokens (S, B, T),
        lengths (S, B) -> (S, B, 2 * staff_emb_size)."""
        return G.bidir_final_fused(self.staff_emb,
                                   L.embed(self.note_emb.weight, tokens),
                                   lengths)

    def sos_token(self, B: int, dev: torch.device) -> torch.Tensor:
        """The first bar's conditioning token: the staff summary of
        [<sos>, <eos>] for both staves, plus the SOS time- and
        key-signature embeddings."""
        cfg = self.cfg
        sos_pair = torch.tensor([[[cfg.sos, cfg.eos]]], device=dev) \
            .repeat(1, B, 1)
        staff0 = self.staff_summaries(
            sos_pair, torch.full((1, B), 2, dtype=torch.long))[0]
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
        (note_decoder_dual_infer). ``decode_chunk`` (None, an int or
        "auto"; ``pick_decode_chunk`` against B): the note decoders stop
        in groups of that many rows; ignored under ``group``, as the JAX
        package ignores it under a mesh.

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
                    note_decoder_dual_infer(dual, cfg, enc_dec, enc_proj2,
                                            bar_summary.to(enc_dec.dtype),
                                            group, chunk)
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
                    rows=rows)
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
