"""Additive (Bahdanau) attention, factored for autoregressive decode.

Port of piano_a2s_tpu/ops/attention.py. The encoder-side projection
``enc @ W_e + b`` is computed once per clip and reused by every decode
step; each step adds only the query projection. The parameters keep the
torch state dict's layout: ``attn`` is Linear(4H -> H) whose input is
[query (2H); encoder frame (2H)], ``v`` is Linear(H -> 1) without bias.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Attention(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.attn = nn.Linear(4 * hidden_size, hidden_size)
        self.v = nn.Linear(hidden_size, 1, bias=False)

    @property
    def w_query(self) -> torch.Tensor:
        """(H, 2H): the query half of ``attn.weight``."""
        return self.attn.weight[:, : 2 * self.hidden_size]

    @property
    def w_enc(self) -> torch.Tensor:
        """(H, 2H): the encoder half of ``attn.weight``."""
        return self.attn.weight[:, 2 * self.hidden_size:]


def precompute_enc_proj(attn: Attention, enc: torch.Tensor) -> torch.Tensor:
    """enc (B, T, 2H) -> enc @ W_e + b (B, T, H), hoisted out of decode."""
    return F.linear(enc, attn.w_enc, attn.attn.bias)


def attention_step(attn: Attention, enc_proj: torch.Tensor,
                   enc: torch.Tensor, query: torch.Tensor):
    """One decode-step read: query (B, 2H) -> (context (B, 2H),
    weights (B, T)). The softmax over frames runs in at least float32."""
    q = F.linear(query, attn.w_query)                  # (B, H)
    energy = torch.tanh(enc_proj + q[:, None, :])      # (B, T, H)
    scores = energy @ attn.v.weight[0]                 # (B, T)
    weights = torch.softmax(
        scores.to(torch.promote_types(scores.dtype, torch.float32)), dim=-1)
    context = torch.einsum("bt,bth->bh", weights.to(enc.dtype), enc)
    return context, weights
