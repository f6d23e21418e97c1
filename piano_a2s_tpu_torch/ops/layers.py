"""Conv / BatchNorm / Linear / Embedding / Dropout helpers.

Port of piano_a2s_tpu/ops/layers.py. Convolutions are NCHW with OIHW
weights, PyTorch's own layout, so a torch state dict loads as it is.
Eval-mode BatchNorm is folded into the preceding conv or linear
(``fold_bn``); training-mode BatchNorm is a function on tensors
(``batch_norm_train``) because ``nn.BatchNorm`` cannot weight the rows of
its batch statistics. The ``nn.BatchNorm`` modules keep the parameters
and the running buffers.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # running = (1 - m) * running + m * batch


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


def _batch_stats(x: torch.Tensor, axes: Sequence[int],
                 weight: Optional[torch.Tensor]):
    """(mean, biased var, unbiased var, wx, n) of x over ``axes``, as
    ``batch_norm_train`` defines them. ``wx`` is the row weight broadcast
    against x (None without ``weight``); ``n`` the count of contributing
    elements per channel (a tensor when weighted)."""
    if weight is not None:
        w = torch.where(weight.sum() > 0, weight,
                        torch.ones_like(weight)).to(x.dtype)
        wx = w.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        per_row = math.prod(x.shape[a] for a in axes if a != 0)
        # n counts the rows that contribute: sum(w) after the fallback.
        n = w.sum() * per_row
        mean = (x * wx).sum(dim=tuple(axes)) / n
        shape_m = [1 if i in axes else x.shape[i] for i in range(x.dim())]
        var = (wx * (x - mean.reshape(shape_m)) ** 2).sum(
            dim=tuple(axes)) / n
        unbiased = var * (n / torch.clamp(n - 1, min=1))
    else:
        wx = None
        mean = x.mean(dim=tuple(axes))
        var = x.var(dim=tuple(axes), correction=0)
        n = x.numel() // mean.numel()
        unbiased = var * (n / max(n - 1, 1))
    return mean, var, unbiased, wx, n


@torch.no_grad()
def _update_running(bn: nn.modules.batchnorm._BatchNorm, mean: torch.Tensor,
                    unbiased: torch.Tensor) -> None:
    bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean
                          + BN_MOMENTUM * mean)
    bn.running_var.copy_((1 - BN_MOMENTUM) * bn.running_var
                         + BN_MOMENTUM * unbiased)


def _channel_shape(x: torch.Tensor, axes: Sequence[int]):
    return [x.shape[i] if i not in axes else 1 for i in range(x.dim())]


def batch_norm_train(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
                     axes: Sequence[int],
                     weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training-mode BatchNorm of x over ``axes`` (axis 0 among them).

    Normalises by the biased batch variance and writes the running
    statistics of ``bn`` in place with the unbiased variance at momentum
    0.1. ``weight`` ((B,), e.g. 0/1) weights each batch row's share of the
    batch statistics, so padding duplicates of a last batch do not bias
    them; an all-zero weight (a fully padded microbatch) falls back to
    unweighted statistics rather than 0/0. ``num_batches_tracked`` is not
    used: the momentum is fixed.
    """
    mean, var, unbiased, _, _ = _batch_stats(x, axes, weight)
    _update_running(bn, mean, unbiased)
    shape = _channel_shape(x, axes)
    inv = torch.rsqrt(var + BN_EPS)
    return ((x - mean.reshape(shape)) * (inv * bn.weight).reshape(shape)
            + bn.bias.reshape(shape))


class _BatchNormReLU(torch.autograd.Function):
    """relu(batch_norm_train(x.to(f)).to(x.dtype)), f = float32_or_wider,
    with a backward that saves only x and the output (in x's dtype; the
    output is the next layer's saved input anyway) and per-channel
    statistics, and recomputes the normalised values from them. The ReLU's
    mask is the output's sign, as the JAX package takes the ReLU after the
    cast.

    Autograd on the straight-line version would save full-size tensors in
    ``f`` (x - mean twice, the ReLU's output): more than the reduced-
    precision activation it stands for.
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, weight, axes):
        fdt = float32_or_wider(x.dtype)
        xf = x.to(fdt, copy=True)
        mean, var, unbiased, wx, n = _batch_stats(xf, axes, weight)
        shape = _channel_shape(x, axes)
        inv = torch.rsqrt(var + BN_EPS)
        scale = (inv * gamma).reshape(shape)
        # batch_norm_train's expression, in place on the fresh copy xf.
        y = xf.sub_(mean.reshape(shape)).mul_(scale).add_(
            beta.reshape(shape)).relu_().to(x.dtype)
        ctx.save_for_backward(x, y, gamma, mean, inv, wx)
        ctx.axes, ctx.n = tuple(axes), n
        ctx.mark_non_differentiable(mean, unbiased)
        return y, mean, unbiased

    @staticmethod
    def backward(ctx, gy, _gmean, _gunbiased):
        x, y, gamma, mean, inv, wx = ctx.saved_tensors
        axes, n = ctx.axes, ctx.n
        shape = _channel_shape(x, axes)
        fdt = mean.dtype
        g = gy.to(fdt, copy=True).masked_fill_(y <= 0, 0.0)
        xhat = x.to(fdt, copy=True).sub_(mean.reshape(shape)).mul_(
            inv.reshape(shape))
        dbeta = g.sum(dim=axes)
        dgamma = (g * xhat).sum(dim=axes)
        # d/dx of gamma * xhat + beta with the (weighted) batch statistics
        # a function of x: inv * gamma * (g - w/n * (dbeta + xhat * dgamma)).
        share = (1.0 / n) if wx is None else wx / n
        dx = xhat.mul_(dgamma.reshape(shape)).add_(dbeta.reshape(shape))
        dx = g.sub_(dx.mul_(share)).mul_((inv * gamma).reshape(shape))
        return dx.to(x.dtype), dgamma, dbeta, None, None


def batch_norm_relu_train(x: torch.Tensor,
                          bn: nn.modules.batchnorm._BatchNorm,
                          axes: Sequence[int],
                          weight: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """relu(batch_norm_train(x)) for a reduced-precision x (bfloat16): the
    statistics and the normalisation in at least float32, the result in
    x's dtype. Writes ``bn``'s running statistics as batch_norm_train does.
    Autograd keeps x, the result and per-channel statistics only
    (``_BatchNormReLU``).
    """
    y, mean, unbiased = _BatchNormReLU.apply(x, bn.weight, bn.bias, weight,
                                             tuple(axes))
    _update_running(bn, mean, unbiased)
    return y


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: each element is kept with probability 1 - rate
    and scaled by 1 / (1 - rate), the mask drawn from ``generator`` (on
    x's device; None draws from the default generator)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
