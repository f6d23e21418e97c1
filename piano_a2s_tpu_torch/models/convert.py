"""Weights for the port: from JAX parameter trees, from torch checkpoint
files, or drawn from a seed.

Every function returns a torch state dict with the keys of the reference
``ScoreTranscription.state_dict()``, which ``ScoreTranscription`` loads
strictly.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .score_transcription import CONV_CHANNELS, ModelConfig


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a copy: inputs may be read-only


def _bn_keys(sd: Dict[str, Any], name: str, scale, bias, mean, var) -> None:
    sd[f"{name}.weight"] = _tensor(scale)
    sd[f"{name}.bias"] = _tensor(bias)
    sd[f"{name}.running_mean"] = _tensor(mean)
    sd[f"{name}.running_var"] = _tensor(var)
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def state_dict_from_jax(params, state, cfg: ModelConfig = ModelConfig()
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``(params, state)`` trees, with numpy leaves, -> torch state dict.

    The JAX package stores linears right-multiplied (in, out), convs HWIO,
    the attention input matrix split into query and encoder halves, GRU
    directions separately, and flattens the conv features f * C + c where
    torch flattens c * F + f.
    """
    sd: Dict[str, Any] = {}

    def put_linear(name, p):
        sd[f"{name}.weight"] = _tensor(np.asarray(p["w"]).T)
        if "b" in p:
            sd[f"{name}.bias"] = _tensor(p["b"])

    def put_gru_dir(name, p, layer, reverse=False):
        sfx = f"l{layer}" + ("_reverse" if reverse else "")
        sd[f"{name}.weight_ih_{sfx}"] = _tensor(np.asarray(p["w_ih"]).T)
        sd[f"{name}.weight_hh_{sfx}"] = _tensor(np.asarray(p["w_hh"]).T)
        sd[f"{name}.bias_ih_{sfx}"] = _tensor(p["b_ih"])
        sd[f"{name}.bias_hh_{sfx}"] = _tensor(p["b_hh"])

    def put_attention(name, p):
        sd[f"{name}.attn.weight"] = _tensor(np.concatenate(
            [np.asarray(p["w_query"]).T, np.asarray(p["w_enc"]).T], axis=1))
        sd[f"{name}.attn.bias"] = _tensor(p["b"])
        sd[f"{name}.v.weight"] = _tensor(np.asarray(p["v"])[None, :])

    def put_note_decoder(name, p):
        sd[f"{name}.embedding.weight"] = _tensor(p["emb"]["emb"])
        put_attention(f"{name}.attn", p["attn"])
        put_gru_dir(f"{name}.gru", p["gru"], 0)
        put_linear(f"{name}.out", p["out"])

    cs, cst = params["convstack"], state["convstack"]
    for i in (1, 2, 3, 4):
        sd[f"convstack.conv{i}.weight"] = _tensor(
            np.asarray(cs[f"conv{i}"]["w"]).transpose(3, 2, 0, 1))
        bn, st = cs[f"bn{i}"], cst[f"bn{i}"]
        _bn_keys(sd, f"convstack.bn{i}", bn["scale"], bn["bias"],
                 st["mean"], st["var"])
    w_out = np.asarray(cs["out"]["w"]).T  # (out, F*C), column f*C + c
    n_out = w_out.shape[0]
    sd["convstack.out.weight"] = _tensor(
        w_out.reshape(n_out, cfg.freq_bins, CONV_CHANNELS[-1])
        .transpose(0, 2, 1).reshape(n_out, -1))  # column c*F + f
    bn, st = cs["out_bn"], cst["out_bn"]
    _bn_keys(sd, "convstack.out_bn", bn["scale"], bn["bias"], st["mean"],
             st["var"])

    enc = params["encoder"]
    put_gru_dir("encoder.gru", enc["l0_fwd"], 0)
    put_gru_dir("encoder.gru", enc["l0_bwd"], 0, reverse=True)
    put_gru_dir("encoder.gru", enc["l1_fwd"], 1)
    put_gru_dir("encoder.gru", enc["l1_bwd"], 1, reverse=True)
    put_linear("encoder.fc", enc["fc"])

    dec = params["decoder"]
    sd["decoder.note_emb.weight"] = _tensor(dec["note_emb"]["emb"])
    sd["decoder.time_sig_emb.weight"] = _tensor(dec["time_sig_emb"]["emb"])
    sd["decoder.key_emb.weight"] = _tensor(dec["key_emb"]["emb"])
    put_gru_dir("decoder.staff_emb", dec["staff_fwd"], 0)
    put_gru_dir("decoder.staff_emb", dec["staff_bwd"], 0, reverse=True)
    put_attention("decoder.attn", dec["attn"])
    put_gru_dir("decoder.gru", dec["gru"], 0)
    for head, tname in (("time_head", "decoder.time_sig_out"),
                        ("key_head", "decoder.key_out")):
        for li, ti in (("l1", 0), ("l2", 2), ("l3", 4)):
            put_linear(f"{tname}.{ti}", dec[head][li])
    put_note_decoder("decoder.upper_decoder", dec["upper"])
    put_note_decoder("decoder.lower_decoder", dec["lower"])
    return sd


def strip_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the ``0.`` prefix of a SpeechBrain ModuleList checkpoint."""
    return {(k[2:] if k.startswith("0.") else k): v for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch .ckpt/.pt/.pth file (bare state dict, ``{"state_dict": ...}``
    or a ``0.``-prefixed ModuleList checkpoint) -> state dict on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return strip_prefix(sd)


# ---------------------------------------------------------------------------
# Random init from a seed (distributions of the JAX package's init_params)
# ---------------------------------------------------------------------------

def init_state_dict(cfg: ModelConfig = ModelConfig(), seed: int = 0,
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """Random weights drawn from ``numpy.random.default_rng(seed)``.

    Matches the distributions of ``piano_a2s_tpu.models.init_params``
    (xavier-uniform linears and convs, the reference's GRU init with an
    orthogonal candidate block where it re-initialises, torch defaults
    elsewhere, N(0, 1) embeddings), not its bits. BatchNorm statistics
    start at mean 0, variance 1.
    """
    rng = np.random.default_rng(seed)
    h, f, e = cfg.hidden_size, cfg.conv_feature_size, cfg.note_emb_size
    sd: Dict[str, Any] = {}

    def uniform(shape, bound):
        return rng.uniform(-bound, bound, shape)

    def xavier(out_dim, in_dim):
        return uniform((out_dim, in_dim), math.sqrt(6.0 / (in_dim + out_dim)))

    def put_linear(name, in_dim, out_dim, mode, bias=True):
        if mode == "torch":
            bound = 1.0 / math.sqrt(in_dim)
            sd[f"{name}.weight"] = uniform((out_dim, in_dim), bound)
            if bias:
                sd[f"{name}.bias"] = uniform((out_dim,), bound)
        else:
            sd[f"{name}.weight"] = xavier(out_dim, in_dim)
            if bias:
                sd[f"{name}.bias"] = np.zeros(out_dim)

    def orthogonal(n):
        q, r = np.linalg.qr(rng.standard_normal((n, n)))
        return q * np.sign(np.diag(r))

    def put_gru_dir(name, in_dim, hid, mode, layer=0, reverse=False):
        sfx = f"l{layer}" + ("_reverse" if reverse else "")
        if mode == "torch":
            bound = 1.0 / math.sqrt(hid)
            w_ih = uniform((3 * hid, in_dim), bound)
            w_hh = uniform((3 * hid, hid), bound)
            b_ih = uniform((3 * hid,), bound)
            b_hh = uniform((3 * hid,), bound)
        else:  # the reference's init_gru
            w_ih = uniform((3 * hid, in_dim), math.sqrt(3.0 / in_dim))
            w_hh = np.concatenate([uniform((2 * hid, hid),
                                           math.sqrt(3.0 / hid)),
                                   orthogonal(hid)])
            b_ih = np.zeros(3 * hid)
            b_hh = np.zeros(3 * hid)
        sd[f"{name}.weight_ih_{sfx}"] = w_ih
        sd[f"{name}.weight_hh_{sfx}"] = w_hh
        sd[f"{name}.bias_ih_{sfx}"] = b_ih
        sd[f"{name}.bias_hh_{sfx}"] = b_hh

    def put_attention(name):
        sd[f"{name}.attn.weight"] = xavier(h, 4 * h)
        sd[f"{name}.attn.bias"] = np.zeros(h)
        sd[f"{name}.v.weight"] = uniform((1, h), math.sqrt(6.0 / (h + 1)))

    def put_bn(name, ch):
        sd[f"{name}.weight"] = np.ones(ch)
        sd[f"{name}.bias"] = np.zeros(ch)
        sd[f"{name}.running_mean"] = np.zeros(ch)
        sd[f"{name}.running_var"] = np.ones(ch)
        sd[f"{name}.num_batches_tracked"] = 0

    chans = (cfg.in_channels,) + CONV_CHANNELS
    for i in range(1, 5):
        sd[f"convstack.conv{i}.weight"] = uniform(
            (chans[i], chans[i - 1], 3, 3),
            math.sqrt(6.0 / ((chans[i - 1] + chans[i]) * 9)))
        put_bn(f"convstack.bn{i}", chans[i])
    put_linear("convstack.out", CONV_CHANNELS[-1] * cfg.freq_bins, f,
               "xavier", bias=False)
    put_bn("convstack.out_bn", f)

    for layer, in_dim in ((0, f), (1, 2 * h)):
        put_gru_dir("encoder.gru", in_dim, h, "piano", layer)
        put_gru_dir("encoder.gru", in_dim, h, "torch", layer, reverse=True)
    put_linear("encoder.fc", 2 * h, h, "xavier")

    sd["decoder.note_emb.weight"] = rng.standard_normal((cfg.vocab_size, e))
    sd["decoder.time_sig_emb.weight"] = rng.standard_normal(
        (cfg.num_time_sig + 1, cfg.time_sig_emb_size))
    sd["decoder.key_emb.weight"] = rng.standard_normal(
        (cfg.num_keys + 1, cfg.key_emb_size))
    put_gru_dir("decoder.staff_emb", e, cfg.staff_emb_size, "torch")
    put_gru_dir("decoder.staff_emb", e, cfg.staff_emb_size, "torch",
                reverse=True)
    put_attention("decoder.attn")
    put_gru_dir("decoder.gru", cfg.bar_gru_in, 2 * h, "piano")
    for tname, n_out in (("decoder.time_sig_out", cfg.num_time_sig),
                         ("decoder.key_out", cfg.num_keys)):
        put_linear(f"{tname}.0", 4 * h, 4 * h, "torch")
        put_linear(f"{tname}.2", 4 * h, 2 * h, "torch")
        put_linear(f"{tname}.4", 2 * h, n_out, "torch")
    for staff in ("upper", "lower"):
        name = f"decoder.{staff}_decoder"
        sd[f"{name}.embedding.weight"] = rng.standard_normal(
            (cfg.vocab_size, e))
        put_attention(f"{name}.attn")
        put_gru_dir(f"{name}.gru", cfg.note_gru_in, 2 * h, "piano")
        put_linear(f"{name}.out", 4 * h, cfg.vocab_size, "xavier")

    return {k: torch.tensor(v, dtype=torch.int64
                            if k.endswith("num_batches_tracked") else dtype)
            for k, v in sd.items()}
