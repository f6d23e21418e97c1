"""Plain reference of the audio-to-score model (arXiv:2405.13527), in torch.

Written from the published description and the configuration's sizes, with
no code of the measured package: the variable-Q frontend, the ConvStack
(four 3x3 conv + BatchNorm + ReLU layers, a flatten-linear + BatchNorm +
ReLU), the two-layer bidirectional GRU encoder with its bridge, and the
hierarchical decoder (a bar-level GRU with additive attention, two note
decoders, the time- and key-signature heads, the staff summaries).

Two entries:

- ``Reference.judge_served``: the greedy decode's outputs (tokens per bar
  and staff, time and key signatures) teacher-forced through the model, so
  that each served token can be held against the reference's best one.
- ``Reference.train_forward``: the training forward (batch-statistics
  BatchNorm, dropout, teacher forcing) with its losses, differentiable.

Precision (``mode``): "f64" computes in float64; "tf32" computes in float32
with every operand of a matrix product or convolution rounded to TF32 (10
mantissa bits), which is what the tensor cores' TF32 mode does to a float32
product. The second one is the control: the step below the float32 that
the configurations state.

Parameter names follow the model's state dict (``param_spec``), so the
benchmark can hand one set of seeded weights to both sides.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CONV_CHANNELS = (20, 20, 40, 40)
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


# ---------------------------------------------------------------------------
# Parameters: names, shapes and the seeded initialisation
# ---------------------------------------------------------------------------

def bar_token_dim(m: dict) -> int:
    return 4 * m["staff_emb_size"] + m["time_sig_emb_size"] + m["key_emb_size"]


def param_spec(m: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) of every tensor of the model's state dict.

    kind "uniform" draws from U(-scale, scale), "normal" from N(0, scale^2),
    "const" fills with scale (the BatchNorm affine parameters and running
    statistics). The bounds follow the paper's code: xavier-uniform convs
    and linears, the GRUs' 1/sqrt(hidden) (sqrt(3/fan) where the paper
    re-initialises), N(0, 1) embeddings.
    """
    h, f, e = m["hidden_size"], m["conv_feature_size"], m["note_emb_size"]
    v, s = m["vocab_size"], m["staff_emb_size"]
    spec: List[Tuple[str, tuple, str, float]] = []

    def uni(name, shape, bound):
        spec.append((name, tuple(shape), "uniform", float(bound)))

    def bn(name, ch):
        spec.extend([(f"{name}.weight", (ch,), "const", 1.0),
                     (f"{name}.bias", (ch,), "const", 0.0),
                     (f"{name}.running_mean", (ch,), "const", 0.0),
                     (f"{name}.running_var", (ch,), "const", 1.0)])

    def linear(name, n_in, n_out, bias=True, torch_default=False):
        bound = (1.0 / math.sqrt(n_in) if torch_default
                 else math.sqrt(6.0 / (n_in + n_out)))
        uni(f"{name}.weight", (n_out, n_in), bound)
        if bias:
            uni(f"{name}.bias", (n_out,),
                1.0 / math.sqrt(n_in) if torch_default else 0.0)

    def gru(name, n_in, hid, sfx, paper=True):
        bi = math.sqrt(3.0 / n_in) if paper else 1.0 / math.sqrt(hid)
        bh = math.sqrt(3.0 / hid) if paper else 1.0 / math.sqrt(hid)
        bb = 0.0 if paper else 1.0 / math.sqrt(hid)
        uni(f"{name}.weight_ih_{sfx}", (3 * hid, n_in), bi)
        uni(f"{name}.weight_hh_{sfx}", (3 * hid, hid), bh)
        uni(f"{name}.bias_ih_{sfx}", (3 * hid,), bb)
        uni(f"{name}.bias_hh_{sfx}", (3 * hid,), bb)

    def attention(name):
        uni(f"{name}.attn.weight", (h, 4 * h), math.sqrt(6.0 / (5 * h)))
        uni(f"{name}.attn.bias", (h,), 0.0)
        uni(f"{name}.v.weight", (1, h), math.sqrt(6.0 / (h + 1)))

    chans = (1,) + CONV_CHANNELS
    for i in range(1, 5):
        uni(f"convstack.conv{i}.weight", (chans[i], chans[i - 1], 3, 3),
            math.sqrt(6.0 / ((chans[i - 1] + chans[i]) * 9)))
        bn(f"convstack.bn{i}", chans[i])
    linear("convstack.out", CONV_CHANNELS[-1] * m["freq_bins"], f, bias=False)
    bn("convstack.out_bn", f)
    for layer, n_in in ((0, f), (1, 2 * h)):
        gru("encoder.gru", n_in, h, f"l{layer}")
        gru("encoder.gru", n_in, h, f"l{layer}_reverse", paper=False)
    linear("encoder.fc", 2 * h, h)
    spec.append(("decoder.note_emb.weight", (v, e), "normal", 1.0))
    spec.append(("decoder.time_sig_emb.weight",
                 (m["num_time_sig"] + 1, m["time_sig_emb_size"]), "normal",
                 1.0))
    spec.append(("decoder.key_emb.weight",
                 (m["num_keys"] + 1, m["key_emb_size"]), "normal", 1.0))
    gru("decoder.staff_emb", e, s, "l0", paper=False)
    gru("decoder.staff_emb", e, s, "l0_reverse", paper=False)
    attention("decoder.attn")
    n_bar_in = bar_token_dim(m) + 2 * h
    gru("decoder.gru", n_bar_in, 2 * h, "l0")
    for head, n_out in (("time_sig_out", m["num_time_sig"]),
                        ("key_out", m["num_keys"])):
        linear(f"decoder.{head}.0", 4 * h, 4 * h, torch_default=True)
        linear(f"decoder.{head}.2", 4 * h, 2 * h, torch_default=True)
        linear(f"decoder.{head}.4", 2 * h, n_out, torch_default=True)
    for staff in ("upper", "lower"):
        name = f"decoder.{staff}_decoder"
        spec.append((f"{name}.embedding.weight", (v, e), "normal", 1.0))
        attention(f"{name}.attn")
        gru(f"{name}.gru", e + 2 * h, 2 * h, "l0")
        linear(f"{name}.out", 4 * h, v)
    return spec


# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Prec:
    """The arithmetic of one reference run: float64, or float32 whose
    products take TF32 operands."""

    def __init__(self, mode: str):
        if mode not in ("f64", "tf32"):
            raise ValueError(f"mode {mode!r}: f64 or tf32")
        self.mode = mode
        self.dtype = torch.float64 if mode == "f64" else torch.float32

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """The operand as the product takes it; a rounded operand passes
        its gradient straight through."""
        if self.mode != "tf32":
            return x
        if x.requires_grad:
            return x + (round_tf32(x.detach()) - x.detach())
        return round_tf32(x)

    def mm(self, a, b):
        return torch.matmul(self.r(a), self.r(b))

    def lin(self, x, w, b=None):
        y = torch.matmul(self.r(x), self.r(w).transpose(-1, -2))
        return y if b is None else y + b

    def conv(self, x, w):
        return F.conv2d(self.r(x), self.r(w), padding=1)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.r(a), self.r(b))


# ---------------------------------------------------------------------------
# Variable-Q frontend
# ---------------------------------------------------------------------------

def vqt_filters(vqt: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) filter banks (window_size, n_bins), float64: each bin a
    hann-windowed complex exponential of its variable-Q length, L1
    normalised, scaled by sqrt(length), centred in the window."""
    n_bins = vqt["bins_per_octave"] * vqt["n_octaves"]
    freqs = vqt["fmin"] * 2.0 ** (np.arange(n_bins) / vqt["bins_per_octave"])
    r = 2.0 ** (2.0 / vqt["bins_per_octave"])
    alpha = (r - 1.0) / (r + 1.0)
    q = vqt["filter_scale"] / alpha
    lengths = q * vqt["sample_rate"] / (freqs + vqt["gamma"] / alpha)
    w = vqt["window_size"]
    if lengths.max() > w:
        raise ValueError("window shorter than the longest filter")
    cos_k = np.zeros((w, n_bins))
    sin_k = np.zeros((w, n_bins))
    for k in range(n_bins):
        t = np.arange(-lengths[k] // 2, lengths[k] // 2)
        n = len(t)
        win = np.hanning(n + 2)[1:-1] if n > 1 else np.ones(1)
        phase = 2.0 * math.pi * freqs[k] / vqt["sample_rate"] * t
        re, im = np.cos(phase) * win, np.sin(phase) * win
        scale = math.sqrt(lengths[k]) / np.sum(np.sqrt(re ** 2 + im ** 2))
        start = (w - n) // 2
        cos_k[start:start + n, k] = re * scale
        sin_k[start:start + n, k] = im * scale
    return cos_k, sin_k


def log_vqt(audio: torch.Tensor, filt, vqt: dict, frames_out: int,
            prec: Prec) -> torch.Tensor:
    """(B, L) audio -> (B, 1, frames_out, n_bins) log-VQT: frames of
    window_size taps every hop (zero padded by half a window at both ends),
    the magnitude of the filter bank's response, librosa's amplitude_to_db
    (ref = the clip's maximum, top 80 dB) / 80 + 1, cut or zero-padded to
    frames_out frames."""
    cos_k, sin_k = filt
    w, hop = vqt["window_size"], vqt["hop_length"]
    x = F.pad(audio.to(prec.dtype), (w // 2, w // 2))
    n = 1 + audio.shape[-1] // hop
    frames = x.unfold(-1, w, hop)[:, :n]
    re = prec.mm(frames, cos_k)
    im = prec.mm(frames, sin_k)
    mag = torch.sqrt(re * re + im * im)
    power = torch.clamp(mag, min=1e-5) ** 2
    db = 10.0 * (torch.log10(power)
                 - torch.log10(power.amax(dim=(1, 2), keepdim=True)))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    spec = db / 80.0 + 1.0
    if n >= frames_out:
        spec = spec[:, :frames_out]
    else:
        spec = F.pad(spec, (0, 0, 0, frames_out - n))
    return spec[:, None]


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _gru_gates(xp, hp, h):
    ir, iz, inn = xp.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inn + r * hn)
    return (1.0 - z) * n + z * h


class Reference:
    """The model on one device in one precision, over a dict of weights."""

    def __init__(self, weights: Dict[str, torch.Tensor], model: dict,
                 vqt: dict, frames: int, mode: str = "f64", device="cpu",
                 requires_grad: bool = False):
        self.m = model
        self.vqt = vqt
        self.frames = frames
        self.prec = Prec(mode)
        self.device = torch.device(device)
        self.p = {k: v.detach().to(self.device, self.prec.dtype).clone()
                  .requires_grad_(requires_grad and not _is_buffer(k))
                  for k, v in weights.items()
                  if not k.endswith("num_batches_tracked")}
        self.filt = tuple(torch.tensor(k, dtype=self.prec.dtype,
                                       device=self.device)
                          for k in vqt_filters(vqt))

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.p.items() if not _is_buffer(k)}

    # -- layers -------------------------------------------------------------

    def _lin(self, x, name, bias=True):
        return self.prec.lin(x, self.p[f"{name}.weight"],
                             self.p.get(f"{name}.bias") if bias else None)

    def _bn_eval(self, y, name, axis):
        shape = [1] * y.dim()
        shape[axis] = -1
        p = self.p
        g = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"] + BN_EPS)
        return ((y - p[f"{name}.running_mean"].reshape(shape)) * g.reshape(shape)
                + p[f"{name}.bias"].reshape(shape))

    def _bn_train(self, y, name, axes):
        """Batch statistics (biased variance normalises); the running
        statistics take the unbiased variance at momentum 0.1."""
        mean = y.mean(dim=axes, keepdim=True)
        var = ((y - mean) ** 2).mean(dim=axes, keepdim=True)
        n = y.numel() // mean.numel()
        p = self.p
        with torch.no_grad():
            rm, rv = p[f"{name}.running_mean"], p[f"{name}.running_var"]
            rm.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.reshape(-1))
            rv.mul_(1 - BN_MOMENTUM).add_(
                BN_MOMENTUM * var.reshape(-1) * n / (n - 1))
        shape = mean.shape
        return ((y - mean) / torch.sqrt(var + BN_EPS)
                * p[f"{name}.weight"].reshape(shape)
                + p[f"{name}.bias"].reshape(shape))

    def convstack(self, spec, train=False, drop=None):
        y = spec.to(self.prec.dtype)
        for i in range(1, 5):
            y = self.prec.conv(y, self.p[f"convstack.conv{i}.weight"])
            y = (self._bn_train(y, f"convstack.bn{i}", (0, 2, 3)) if train
                 else self._bn_eval(y, f"convstack.bn{i}", 1))
            y = torch.relu(y)
        b, c, t, f = y.shape
        y = y.permute(0, 2, 1, 3).reshape(b, t, c * f)
        y = self._lin(y, "convstack.out", bias=False)
        y = (self._bn_train(y, "convstack.out_bn", (0, 1)) if train
             else self._bn_eval(y, "convstack.out_bn", 2))
        y = torch.relu(y)
        if drop is not None:
            y = y * drop
        return y

    def _bigru(self, x, name, sfx):
        """One bidirectional layer over (B, T, in): outputs (B, T, 2H) and
        the two directions' final states (2, B, H)."""
        p = self.p
        dirs = (f"{name}.%s_{sfx}", f"{name}.%s_{sfx}_reverse")
        xp = [self.prec.lin(x, p[d % "weight_ih"], p[d % "bias_ih"])
              for d in dirs]
        w_hh = torch.stack([p[d % "weight_hh"] for d in dirs]).transpose(1, 2)
        b_hh = torch.stack([p[d % "bias_hh"] for d in dirs])[:, None]
        bsz, t_len = x.shape[:2]
        hid = w_hh.shape[1]
        h = x.new_zeros((2, bsz, hid))
        outs = []
        for t in range(t_len):
            xt = torch.stack([xp[0][:, t], xp[1][:, t_len - 1 - t]])
            h = _gru_gates(xt, torch.baddbmm(b_hh, self.prec.r(h),
                                             self.prec.r(w_hh)), h)
            outs.append(h)
        fwd = torch.stack([o[0] for o in outs], dim=1)
        bwd = torch.stack([o[1] for o in outs[::-1]], dim=1)
        return torch.cat([fwd, bwd], dim=-1), h

    def encoder(self, feats):
        y, h0 = self._bigru(feats, "encoder.gru", "l0")
        enc, h1 = self._bigru(y, "encoder.gru", "l1")
        bridge = [torch.tanh(self._lin(torch.cat([h[0], h[1]], -1),
                                       "encoder.fc")) for h in (h0, h1)]
        return enc, torch.cat(bridge, dim=-1)

    def _gru_cell(self, x, h, name):
        p = self.p
        return _gru_gates(
            self.prec.lin(x, p[f"{name}.weight_ih_l0"], p[f"{name}.bias_ih_l0"]),
            self.prec.lin(h, p[f"{name}.weight_hh_l0"], p[f"{name}.bias_hh_l0"]),
            h)

    def _attend(self, name, enc_proj, enc, query):
        """Additive attention: softmax over frames of v . tanh(W_e enc + b +
        W_q query); returns (context, weights)."""
        h = self.m["hidden_size"]
        w = self.p[f"{name}.attn.weight"]
        q = self.prec.lin(query, w[:, :2 * h])
        energy = torch.tanh(enc_proj + q[:, None, :])
        scores = self.prec.mm(energy, self.p[f"{name}.v.weight"][0])
        weights = torch.softmax(scores, dim=-1)
        return self.prec.einsum("bt,bth->bh", weights, enc), weights

    def _enc_proj(self, name, enc):
        h = self.m["hidden_size"]
        return self.prec.lin(enc, self.p[f"{name}.attn.weight"][:, 2 * h:],
                             self.p[f"{name}.attn.bias"])

    def staff_summary(self, tokens, lengths):
        """Final states of the bidirectional staff GRU over each sequence's
        first ``lengths`` tokens: tokens (N, T) long, lengths (N,) >= 1 ->
        (N, 2 * staff_emb_size). The backward direction starts at the
        sequence's last token."""
        p = self.p
        n, t_len = tokens.shape
        lengths = lengths.to(self.device).long()
        steps = torch.arange(t_len, device=self.device)
        rev = torch.where(steps[None] < lengths[:, None],
                          lengths[:, None] - 1 - steps[None], steps[None])
        emb = p["decoder.note_emb.weight"]
        x = torch.stack([emb[tokens], emb[tokens.gather(1, rev)]])
        pre = "decoder.staff_emb.%s_l0"
        dirs = (pre, pre + "_reverse")
        w_ih = torch.stack([p[d % "weight_ih"] for d in dirs]).transpose(1, 2)
        b_ih = torch.stack([p[d % "bias_ih"] for d in dirs])[:, None, None]
        w_hh = torch.stack([p[d % "weight_hh"] for d in dirs]).transpose(1, 2)
        b_hh = torch.stack([p[d % "bias_hh"] for d in dirs])[:, None]
        xp = torch.matmul(self.prec.r(x), self.prec.r(w_ih)[:, None]) + b_ih
        h = x.new_zeros((2, n, w_hh.shape[1]))
        last = x.new_zeros((2, n, w_hh.shape[1]))
        t_max = int(lengths.max())
        for t in range(t_max):
            h = _gru_gates(xp[:, :, t], torch.baddbmm(
                b_hh, self.prec.r(h), self.prec.r(w_hh)), h)
            last = torch.where((lengths == t + 1)[None, :, None], h, last)
        return torch.cat([last[0], last[1]], dim=-1)

    def _sos_token(self, bsz):
        m = self.m
        pair = torch.tensor([[m["sos"], m["eos"]]], device=self.device)
        staff0 = self.staff_summary(pair, torch.tensor([2])).expand(bsz, -1)
        ts0 = self.p["decoder.time_sig_emb.weight"][m["num_time_sig"]]
        key0 = self.p["decoder.key_emb.weight"][m["num_keys"]]
        return torch.cat([staff0, staff0, ts0.expand(bsz, -1),
                          key0.expand(bsz, -1)], dim=-1)

    def _head(self, name, x):
        y = torch.relu(self._lin(x, f"decoder.{name}.0"))
        y = torch.relu(self._lin(y, f"decoder.{name}.2"))
        return torch.log_softmax(self._lin(y, f"decoder.{name}.4"), dim=-1)

    def _note_step(self, s, enc, enc_proj, h, tok_emb):
        """One note-decoder step of staff ``s``: attention with the previous
        state as query, the GRU on [token embedding; context], the head on
        [state; context]. Returns (state, log-probs)."""
        name = f"decoder.{('upper', 'lower')[s]}_decoder"
        ctx, _ = self._attend(f"{name}.attn", enc_proj, enc, h)
        h = self._gru_cell(torch.cat([tok_emb, ctx], dim=-1), h, f"{name}.gru")
        out = self._lin(torch.cat([h, ctx], dim=-1), f"{name}.out")
        return h, torch.log_softmax(out, dim=-1)

    def encode(self, audio):
        with torch.no_grad():
            spec = log_vqt(audio.to(self.device), self.filt, self.vqt,
                           self.frames, self.prec)
        return self.encoder(self.convstack(spec))

    # -- serving: the served tokens teacher-forced ---------------------------

    @torch.no_grad()
    def judge_served(self, audio, served) -> dict:
        """Log-probs of the greedy decode's choices, teacher-forced.

        ``served``: time_sig (B, bars), key (B, bars), upper / lower
        (B, bars, cap) tokens and upper_len / lower_len (B, bars), as the
        decode returned them (the lengths derived from its stop, see
        judge.stop_structure). Each note decoder is fed SOS then its served
        tokens; each bar's conditioning token is built from the served
        tokens and signatures. Returns log-probs: "time_sig" (B, bars, 7),
        "key" (B, bars, 14), "upper" (B, bars, cap_u, V), "lower" likewise,
        all float tensors on the CPU in this precision.
        """
        m = self.m
        enc, hidden = self.encode(audio)
        bsz = enc.shape[0]
        enc_bar = self._enc_proj("decoder.attn", enc)
        enc_st = [self._enc_proj(f"decoder.{n}_decoder.attn", enc)
                  for n in ("upper", "lower")]
        toks = [served["upper"].to(self.device).long(),
                served["lower"].to(self.device).long()]
        lens = [served["upper_len"].to(self.device).long(),
                served["lower_len"].to(self.device).long()]
        ts_srv = served["time_sig"].to(self.device).long()
        key_srv = served["key"].to(self.device).long()
        token = self._sos_token(bsz)
        out = {"time_sig": [], "key": [], "upper": [], "lower": []}
        for j in range(m["max_bars"]):
            ctx, _ = self._attend("decoder.attn", enc_bar, enc, hidden)
            hidden = self._gru_cell(torch.cat([token, ctx], dim=-1), hidden,
                                    "decoder.gru")
            for s, staff in enumerate(("upper", "lower")):
                emb = self.p[f"decoder.{staff}_decoder.embedding.weight"]
                cap = toks[s].shape[-1]
                prev = torch.cat([torch.full((bsz, 1), m["sos"],
                                             device=self.device),
                                  toks[s][:, j, :cap - 1]], dim=1)
                h = hidden
                logps = []
                for t in range(cap):
                    h, lp = self._note_step(s, enc, enc_st[s], h,
                                            emb[prev[:, t]])
                    logps.append(lp)
                out[staff].append(torch.stack(logps, dim=1).cpu())
            head_in = torch.cat([hidden, ctx], dim=-1)
            out["time_sig"].append(self._head("time_sig_out", head_in).cpu())
            out["key"].append(self._head("key_out", head_in).cpu())
            sums = self.staff_summary(
                torch.cat([toks[0][:, j], F.pad(
                    toks[1][:, j], (0, toks[0].shape[-1] - toks[1].shape[-1]),
                    value=m["pad"])]),
                torch.cat([lens[0][:, j], lens[1][:, j]]).clamp(min=1))
            token = torch.cat([
                sums[:bsz], sums[bsz:],
                self.p["decoder.time_sig_emb.weight"][ts_srv[:, j]],
                self.p["decoder.key_emb.weight"][key_srv[:, j]]], dim=-1)
        return {k: torch.stack(v, dim=1) for k, v in out.items()}

    # -- training: the teacher-forced forward and its losses -----------------

    min_margin = float("inf")

    def _note_margin(self, logp):
        """Keep the smallest gap between the best and the second best
        log-prob where a prediction, not the target, is fed on: where a
        program's rounding can pick the other token."""
        top = logp.detach().topk(2, dim=-1).values
        self.min_margin = min(self.min_margin,
                              float((top[..., 0] - top[..., 1]).min()))

    def train_forward(self, audio, batch, draws) -> Tuple[torch.Tensor, dict]:
        """The training forward of one batch and its loss (time + key +
        upper + lower negative log-likelihoods, the staves' means over
        non-pad targets).

        ``batch``: time_sig, key (B, bars), upper / lower (B, bars, T_s)
        padded with <pad> after one <eos>, upper_lengths / lower_lengths
        (B, bars), the tokens before the <eos>. ``draws`` (``Draws``): the
        step's dropout keeps and teacher-forcing coins. A note decoder's
        next input is the target where its staff's coin says so, else its
        own best token; the next bar is conditioned on the ground truth's
        summaries where the bar's coin says so, else on the predictions'.
        """
        m = self.m
        with torch.no_grad():
            spec = log_vqt(audio.to(self.device), self.filt, self.vqt,
                           self.frames, self.prec)
        feats = self.convstack(spec, train=True,
                               drop=draws.conv.to(self.prec.dtype))
        enc, hidden = self.encoder(feats)
        bsz = enc.shape[0]
        dev = self.device
        tgt = {k: torch.as_tensor(np.asarray(v), device=dev).long()
               for k, v in batch.items()}
        gts = [tgt["upper"], tgt["lower"]]
        t_len = max(g.shape[-1] for g in gts)
        # Each staff's lengths: up to and including its <eos> (one per bar
        # and clip in these targets).
        lens_pred = [(g == m["eos"]).int().argmax(dim=-1) + 1 for g in gts]
        lens_gt = [tgt["upper_lengths"], tgt["lower_lengths"]]
        enc_bar = self._enc_proj("decoder.attn", enc)
        enc_st = [self._enc_proj(f"decoder.{n}_decoder.attn", enc)
                  for n in ("upper", "lower")]
        keep_scale = 1.0 / 0.9
        token = self._sos_token(bsz)
        ts_lp, key_lp, picked = [], [], ([], [])
        for j in range(m["max_bars"]):
            token = token * draws.token[j].to(self.prec.dtype) * keep_scale
            ctx, _ = self._attend("decoder.attn", enc_bar, enc, hidden)
            hidden = self._gru_cell(torch.cat([token, ctx], dim=-1), hidden,
                                    "decoder.gru")
            preds = []
            hs = [hidden, hidden]
            toks_in = [torch.full((bsz,), m["sos"], device=dev)] * 2
            per_staff = ([], [])
            pred_staff = ([], [])
            for t in range(t_len):
                for s, staff in enumerate(("upper", "lower")):
                    emb = self.p[f"decoder.{staff}_decoder.embedding.weight"]
                    tok = (emb[toks_in[s]] * draws.note[j][t, s]
                           .to(self.prec.dtype) * keep_scale)
                    hs[s], lp = self._note_step(s, enc, enc_st[s], hs[s], tok)
                    gt_t = gts[s][:, j, t] if t < gts[s].shape[-1] else \
                        torch.full((bsz,), m["pad"], device=dev)
                    pred = lp.argmax(dim=-1)
                    if not bool(draws.coins[j][t, s]):
                        self._note_margin(lp)
                    toks_in[s] = torch.where(draws.coins[j][t, s], gt_t, pred)
                    per_staff[s].append(lp.gather(-1, gt_t[:, None])[:, 0])
                    pred_staff[s].append(pred)
            for s in range(2):
                w = gts[s].shape[-1]
                picked[s].append(torch.stack(per_staff[s][:w], dim=1))
                preds.append(torch.stack(pred_staff[s], dim=1))
            head_in = torch.cat([hidden, ctx], dim=-1)
            ts = self._head("time_sig_out", head_in)
            key = self._head("key_out", head_in)
            ts_lp.append(ts)
            key_lp.append(key)

            def pad_t(a):
                return F.pad(a, (0, t_len - a.shape[1]), value=m["pad"])

            sums = self.staff_summary(
                torch.cat([pad_t(preds[0][:, :gts[0].shape[-1]]),
                           pad_t(preds[1][:, :gts[1].shape[-1]]),
                           pad_t(gts[0][:, j]), pad_t(gts[1][:, j])]),
                torch.cat([lens_pred[0][:, j], lens_pred[1][:, j],
                           lens_gt[0][:, j], lens_gt[1][:, j]]))
            s4 = sums.reshape(4, bsz, -1)
            tok_pred = torch.cat([
                s4[0], s4[1],
                self.p["decoder.time_sig_emb.weight"][ts.argmax(dim=-1)],
                self.p["decoder.key_emb.weight"][key.argmax(dim=-1)]], dim=-1)
            tok_gt = torch.cat([
                s4[2], s4[3],
                self.p["decoder.time_sig_emb.weight"][tgt["time_sig"][:, j]],
                self.p["decoder.key_emb.weight"][tgt["key"][:, j]]], dim=-1)
            if not bool(draws.bar_coins[j]):
                self._note_margin(ts)
                self._note_margin(key)
            token = torch.where(draws.bar_coins[j], tok_gt, tok_pred)
        ts_lp = torch.stack(ts_lp, dim=1)
        key_lp = torch.stack(key_lp, dim=1)
        comps = {
            "time_loss": -ts_lp.gather(-1, tgt["time_sig"][..., None]).mean(),
            "key_loss": -key_lp.gather(-1, tgt["key"][..., None]).mean()}
        for s, staff in enumerate(("upper", "lower")):
            lp = torch.stack(picked[s], dim=1)
            mask = (gts[s] != m["pad"]).to(lp.dtype)
            comps[f"{staff}_loss"] = -(lp * mask).sum() / mask.sum()
        return sum(comps.values()), comps


def _is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


class Draws:
    """The random numbers of one training step, drawn in the order in which
    the training step draws them from its generator: the ConvStack output's
    dropout keeps (rate 0.2), then per bar the conditioning token's keeps
    (rate 0.1), the note decoders' token keeps (rate 0.1) and their
    teacher-forcing coins (one per step and staff), and the bar's coin."""

    def __init__(self, gen: torch.Generator, device, bsz: int, frames: int,
                 model: dict, t_len: int, tf_ratio: float):
        def keep(shape, rate):
            return torch.rand(shape, generator=gen, device=device) < 1 - rate

        self.conv = keep((bsz, frames, model["conv_feature_size"]), 0.2) \
            .float() / 0.8
        self.token, self.note, self.coins, self.bar_coins = [], [], [], []
        for _ in range(model["max_bars"]):
            self.token.append(keep((bsz, bar_token_dim(model)), 0.1))
            self.note.append(keep((t_len, 2, bsz, model["note_emb_size"]),
                                  0.1))
            self.coins.append(torch.rand((t_len, 2), generator=gen,
                                         device=device) < tf_ratio)
            self.bar_coins.append(torch.rand((), generator=gen,
                                             device=device) < tf_ratio)
