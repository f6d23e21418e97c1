"""GRU helpers (cuDNN / PyTorch gate convention).

Port of piano_a2s_tpu/ops/gru.py. Weights are in ``nn.GRU``'s layout:
``weight_ih (3H, in)``, ``weight_hh (3H, H)``, gates in (r, z, n) order:

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

The encoder's two bidirectional layers are a plain ``nn.GRU``; this module
adds the single step used by the decoders and the packed final hidden of
the staff summariser.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.nn.utils.rnn import pack_padded_sequence


def gru_gates(x_proj: torch.Tensor, h_proj: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """The gate equations, given both projections (biases included)."""
    ir, iz, inn = x_proj.chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inn + r * hn)
    return (1.0 - z) * n + z * h


def gru_step(gru: nn.GRU, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One step of a single-layer unidirectional ``gru``: x (B, in),
    h (B, H) -> h' (B, H)."""
    x_proj = torch.nn.functional.linear(x, gru.weight_ih_l0, gru.bias_ih_l0)
    h_proj = torch.nn.functional.linear(h, gru.weight_hh_l0, gru.bias_hh_l0)
    return gru_gates(x_proj, h_proj, h)


def bidir_final_fused(gru: nn.GRU, xs: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Final bidirectional hidden of S x B variable-length sequences.

    All S x B sequences run through the bidirectional, batch-first ``gru``
    in one packed call. Packing gives torch's final-hidden semantics: the
    forward direction stops after position length-1, and the backward
    direction starts AT position length-1 (not at the padded end).

    xs: (S, B, T, in); lengths: (S, B) int, each >= 1. Returns (S, B, 2H).
    """
    S, B, T, F = xs.shape
    packed = pack_padded_sequence(xs.reshape(S * B, T, F),
                                  lengths.reshape(S * B).cpu(),
                                  batch_first=True, enforce_sorted=False)
    _, h_n = gru(packed)  # (2, S*B, H), in the input order
    return torch.cat([h_n[0], h_n[1]], dim=-1).reshape(S, B, -1)
