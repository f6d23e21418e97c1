"""Conv / BatchNorm-fold / Linear / Embedding helpers for inference.

The eval subset of piano_a2s_tpu/ops/layers.py. Convolutions are NCHW with
OIHW weights, PyTorch's own layout, so a torch state dict loads as it is.
Training-mode BatchNorm (with its weighted batch statistics) is not ported
yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def float32_or_wider(dtype: torch.dtype) -> torch.dtype:
    """dtype promoted to at least float32 (float64 stays float64)."""
    return torch.promote_types(dtype, torch.float32)


def fold_bn(weight: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
            bias: Optional[torch.Tensor] = None,
            dtype: Optional[torch.dtype] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an eval-mode BatchNorm into the preceding conv or linear.

    ``weight`` has its output channel on axis 0 (OIHW conv, (out, in)
    linear). Returns (weight * g, beta - mean * g [+ bias * g]) with
    g = gamma / sqrt(var + eps), computed in at least float32 and cast to
    ``dtype`` (default: the weight's dtype).
    """
    fdt = float32_or_wider(weight.dtype)
    g = bn.weight.to(fdt) * torch.rsqrt(bn.running_var.to(fdt) + BN_EPS)
    w = weight.to(fdt) * g.reshape((-1,) + (1,) * (weight.dim() - 1))
    b = bn.bias.to(fdt) - bn.running_mean.to(fdt) * g
    if bias is not None:
        b = b + bias.to(fdt) * g
    out_dtype = dtype or weight.dtype
    return w.to(out_dtype), b.to(out_dtype)


def conv2d_same(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv, NCHW/OIHW."""
    return F.conv2d(x, weight, bias, padding=1)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T + bias, with weight in torch's (out, in) layout."""
    return F.linear(x, weight, bias)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table)
