"""ScoreTranscription model, inference half (PyTorch).

Port of piano_a2s_tpu/models/score_transcription.py for ``train=False``:

    spectrogram (B, 1, T=1201, F=480)
      -> ConvStack: 4x [3x3 conv + BN + ReLU] -> flatten (C, F) -> Linear+BN
         -> (B, T, 256)
      -> Encoder: 2-layer bidirectional GRU -> enc (B, T, 512), bridge
         hidden (B, 512)
      -> HierarchicalDecoder: per bar, a GRU step with additive attention
         gives the bar summary; two note decoders (upper and lower staff)
         decode greedily; MLP heads give time and key signature.

Parameter names are those of the torch reference state dict (the keys
``piano_a2s_tpu.models.convert.to_torch_state_dict`` emits), so a converted
JAX checkpoint or an upstream checkpoint loads strictly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import attention as A
from ..ops import gru as G
from ..ops import layers as L

CONV_CHANNELS = (20, 20, 40, 40)


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
                       cfg: ModelConfig) -> DualDecodeParams:
    """Stack both staves' weights and apply the two exact rewrites of the
    greedy step: the query projection rides in the recurrent matmul
    (h @ [W_hh | W_q]), and the token-side input projection is folded into
    the embedding table (emb @ W_ih_tok), so embed + matmul is one gather.
    """
    E = cfg.note_emb_size

    def both(fn):
        return torch.stack([fn(upper), fn(lower)])

    w_ih = both(lambda d: d.gru.weight_ih_l0)                 # (2, 3H2, in)
    w_hh = both(lambda d: d.gru.weight_hh_l0)                 # (2, 3H2, H2)
    w_q = both(lambda d: d.attn.w_query)                      # (2, H, H2)
    emb = both(lambda d: d.embedding.weight)                  # (2, V, E)
    return DualDecodeParams(
        w_hq=torch.cat([w_hh, w_q], dim=1).transpose(1, 2),
        b_hh=both(lambda d: d.gru.bias_hh_l0),
        b_ih=both(lambda d: d.gru.bias_ih_l0),
        emb_proj=torch.bmm(emb, w_ih[:, :, :E].transpose(1, 2)),
        w_ih_ctx=w_ih[:, :, E:].transpose(1, 2),
        v=both(lambda d: d.attn.v.weight[0]),
        w_out=both(lambda d: d.out.weight).transpose(1, 2),
        b_out=both(lambda d: d.out.bias))


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
                            h0: torch.Tensor):
    """Greedy decode of both staves with the reference's early exit.

    Staff s steps while t < its cap and not every batch item has emitted
    EOS; its buffers stay zero after it stops. An item's length is its
    last EOS step + 1 (the cap if it never emitted EOS). The loop reads
    the stop condition on the host every step.

    Returns per staff (logp (B, T_s, V), tokens (B, T_s), lengths (B,)).
    """
    B, dev = enc.shape[0], enc.device
    caps = tuple(cfg.max_length)
    T = max(caps)
    logps = torch.zeros((T, 2, B, cfg.vocab_size),
                        dtype=L.float32_or_wider(enc.dtype), device=dev)
    preds = torch.zeros((T, 2, B), dtype=torch.long, device=dev)
    done = torch.zeros((2, B), dtype=torch.bool, device=dev)
    lengths = torch.tensor(caps, device=dev)[:, None].repeat(1, B)
    h2 = torch.stack([h0, h0])
    tok2 = _tok_proj(p, torch.full((2, B), cfg.sos, dtype=torch.long,
                                   device=dev))
    masks = {}
    for t in range(T):
        all_done = done.all(dim=1).tolist()
        act = tuple(t < caps[s] and not all_done[s] for s in range(2))
        if not any(act):
            break
        if act not in masks:
            masks[act] = torch.tensor(act, device=dev)
        m = masks[act]
        h2_new, logp2, pred2 = _fast_step(p, enc, enc_proj2, h2, tok2)
        h2 = torch.where(m[:, None, None], h2_new, h2)
        logps[t] = torch.where(m[:, None, None], logp2, 0.0)
        preds[t] = torch.where(m[:, None], pred2, 0)
        is_eos = (pred2 == cfg.eos) & m[:, None]
        lengths = torch.where(is_eos, t + 1, lengths)
        done = done | is_eos
        tok2 = torch.where(m[:, None, None], _tok_proj(p, pred2), tok2)
    out = []
    for s, cap in enumerate(caps):
        out.append((logps[:cap, s].transpose(0, 1),
                    preds[:cap, s].transpose(0, 1), lengths[s]))
    return tuple(out)


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

    def forward(self, enc: torch.Tensor, hidden: torch.Tensor):
        """Greedy decode of max_bars bars (no ground truth).

        Returns (time_sig_logp (B, bars, 7), key_logp (B, bars, 14),
        upper_logp (B, bars, Tu, V), lower_logp (B, bars, Tl, V), aux) with
        aux holding per-bar tokens (B, bars, T_s) and lengths (B, bars).
        """
        cfg = self.cfg
        B, dev = enc.shape[0], enc.device
        enc_proj_bar = A.precompute_enc_proj(self.attn, enc)
        enc_proj2 = torch.stack([
            A.precompute_enc_proj(self.upper_decoder.attn, enc),
            A.precompute_enc_proj(self.lower_decoder.attn, enc)])
        dual = dual_decode_params(self.upper_decoder, self.lower_decoder,
                                  cfg)

        # SOS bootstrap token: the staff summary of [<sos>, <eos>] for both
        # staves, plus the SOS time- and key-signature embeddings.
        sos_pair = torch.tensor([[[cfg.sos, cfg.eos]]], device=dev) \
            .repeat(1, B, 1)
        staff0 = self.staff_summaries(
            sos_pair, torch.full((1, B), 2, dtype=torch.long))[0]
        time0 = self.time_sig_emb.weight[cfg.num_time_sig].expand(B, -1)
        key0 = self.key_emb.weight[cfg.num_keys].expand(B, -1)
        token = torch.cat([staff0, staff0, time0, key0], dim=-1)

        t_s = max(cfg.max_length)
        outs = []
        for _ in range(cfg.max_bars):
            context, _ = A.attention_step(self.attn, enc_proj_bar, enc,
                                          hidden)
            bar_summary = G.gru_step(self.gru,
                                     torch.cat([token, context], dim=-1),
                                     hidden)
            hidden = bar_summary
            (up_logp, up_tok, up_len), (low_logp, low_tok, low_len) = \
                note_decoder_dual_infer(dual, cfg, enc, enc_proj2,
                                        bar_summary)
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
        """(B, 1, T, F) -> (enc (B, T, 2H), bridge hidden (B, 2H))."""
        feats = self.convstack(spectrogram)
        return self.encoder(feats.to(L.float32_or_wider(feats.dtype)))

    @torch.no_grad()
    def forward(self, spectrogram: torch.Tensor, train: bool = False):
        """Inference forward: spectrogram (B, 1, T, F) -> (time_sig_logp,
        key_logp, upper_logp, lower_logp, aux), greedy and deterministic.
        """
        if train:
            raise NotImplementedError(
                "the training forward is not ported yet")
        enc, hidden = self.encode(spectrogram)
        return self.decoder(enc, hidden)
