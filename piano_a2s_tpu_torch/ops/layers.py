"""Conv / BatchNorm / Linear / Embedding / Dropout helpers.

Port of piano_a2s_tpu/ops/layers.py. Convolutions are NCHW with OIHW
weights, PyTorch's own layout, so a torch state dict loads as it is.
Eval-mode BatchNorm is folded into the preceding conv or linear
(``fold_bn``); training-mode BatchNorm is a function on tensors
(``batch_norm_train``) because ``nn.BatchNorm`` cannot weight the rows of
its batch statistics. The ``nn.BatchNorm`` modules keep the parameters
and the running buffers.

Under data parallelism (a ``group`` of ranks, each holding its rows of the
batch) the training BatchNorm's statistics are those of the global batch,
as the JAX package's one program computes them: SyncBatchNorm with the
row weights kept.
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
                 weight: Optional[torch.Tensor], group=None,
                 counted: Optional[torch.Tensor] = None):
    """(mean, biased var, unbiased var, wx, n) of x over ``axes``, as
    ``batch_norm_train`` defines them. ``wx`` is the row weight broadcast
    against x (None without ``weight``); ``n`` the count of contributing
    elements per channel (a tensor when weighted).

    With ``group`` (data parallelism) the statistics are over the rows of
    every rank, weighted (a weight of 1 per row when ``weight`` is None):
    the sums are all-reduced before the mean and before the variance. The
    all-zero weight fallback is decided on the global sum of the weights,
    so a rank whose rows are all padding still takes the others' weighted
    statistics. The all-reduces are differentiable (their backward
    all-reduces the gradients), so autograd carries each rank's share of
    the statistics' gradient to the other ranks' rows.

    ``counted`` (B,) 0/1 marks the rows the fallback counts (default all):
    a data-parallel rank's stand-in row (``parallel.step_rows``) has 0
    there as well as a weight of 0, so it adds nothing in either case."""
    red = tuple(axes)
    if weight is None and group is None and counted is None:
        mean = x.mean(dim=red)
        var = x.var(dim=red, correction=0)
        n = x.numel() // mean.numel()
        return mean, var, var * (n / max(n - 1, 1)), None, n

    def summed(t):
        if group is None:
            return t
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(t, group=group)

    row_shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    if counted is None:
        ones = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        plain = x.sum(dim=red)
    else:
        ones = counted.to(x.dtype)
        plain = (x * ones.reshape(row_shape)).sum(dim=red)
    w = ones if weight is None else weight.to(x.dtype)
    stat_shape = [x.shape[i] for i in range(x.dim()) if i not in red]
    per_row = math.prod(x.shape[a] for a in axes if a != 0)
    # One vector: the weighted and the plain sums per channel, sum(w) and
    # the count of counted rows; the plain ones serve the all-zero weight
    # fallback.
    sums = summed(torch.cat([
        (x * w.reshape(row_shape)).sum(dim=red).reshape(-1),
        plain.reshape(-1), w.sum()[None], ones.sum()[None]]))
    k = (sums.numel() - 2) // 2
    weighted = sums[-2] > 0
    # n counts the rows that contribute: sum(w) after the fallback.
    n = torch.where(weighted, sums[-2], sums[-1]) * per_row
    mean = (torch.where(weighted, sums[:k], sums[k:2 * k]) / n
            ).reshape(stat_shape)
    wx = torch.where(weighted, w, ones).reshape(row_shape)
    shape_m = [1 if i in red else x.shape[i] for i in range(x.dim())]
    var = summed((wx * (x - mean.reshape(shape_m)) ** 2).sum(dim=red)) / n
    unbiased = var * (n / torch.clamp(n - 1, min=1))
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
                     weight: Optional[torch.Tensor] = None,
                     group=None,
                     counted: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training-mode BatchNorm of x over ``axes`` (axis 0 among them).

    Normalises by the biased batch variance and writes the running
    statistics of ``bn`` in place with the unbiased variance at momentum
    0.1. ``weight`` ((B,), e.g. 0/1) weights each batch row's share of the
    batch statistics, so padding duplicates of a last batch do not bias
    them; an all-zero weight (a fully padded microbatch) falls back to
    unweighted statistics rather than 0/0. ``num_batches_tracked`` is not
    used: the momentum is fixed. With ``group`` (data parallelism) the
    statistics, the fallback and the running update are the global batch's
    (``_batch_stats``), the same on every rank; ``counted`` marks the rows
    that the fallback counts (0 for a rank's stand-in rows).
    """
    mean, var, unbiased, _, _ = _batch_stats(x, axes, weight, group,
                                             counted)
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

    With ``group`` the statistics are the global batch's, and the backward
    all-reduces its per-channel sums before it forms dx (SyncBatchNorm's
    backward, with the row weights kept); gamma and beta get this rank's
    own sums, which the gradient all-reduce adds up.
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, weight, axes, group=None,
                counted=None):
        fdt = float32_or_wider(x.dtype)
        xf = x.to(fdt, copy=True)
        mean, var, unbiased, wx, n = _batch_stats(xf, axes, weight, group,
                                                  counted)
        shape = _channel_shape(x, axes)
        inv = torch.rsqrt(var + BN_EPS)
        scale = (inv * gamma).reshape(shape)
        # batch_norm_train's expression, in place on the fresh copy xf.
        y = xf.sub_(mean.reshape(shape)).mul_(scale).add_(
            beta.reshape(shape)).relu_().to(x.dtype)
        ctx.save_for_backward(x, y, gamma, mean, inv, wx)
        ctx.axes, ctx.n, ctx.group = tuple(axes), n, group
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
        sum_beta, sum_gamma = dbeta, dgamma
        if ctx.group is not None:  # the sums over every rank's rows
            both = torch.cat([dbeta, dgamma])
            torch.distributed.all_reduce(both, group=ctx.group)
            sum_beta, sum_gamma = both.split(dbeta.numel())
        # d/dx of gamma * xhat + beta with the (weighted) batch statistics
        # a function of x: inv * gamma * (g - w/n * (dbeta + xhat * dgamma)).
        share = (1.0 / n) if wx is None else wx / n
        dx = xhat.mul_(sum_gamma.reshape(shape)).add_(sum_beta.reshape(shape))
        dx = g.sub_(dx.mul_(share)).mul_((inv * gamma).reshape(shape))
        return dx.to(x.dtype), dgamma, dbeta, None, None, None, None


def batch_norm_relu_train(x: torch.Tensor,
                          bn: nn.modules.batchnorm._BatchNorm,
                          axes: Sequence[int],
                          weight: Optional[torch.Tensor] = None,
                          group=None,
                          counted: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """relu(batch_norm_train(x)) for a reduced-precision x (bfloat16): the
    statistics and the normalisation in at least float32, the result in
    x's dtype. Writes ``bn``'s running statistics as batch_norm_train does.
    Autograd keeps x, the result and per-channel statistics only
    (``_BatchNormReLU``). ``group`` and ``counted``: see
    batch_norm_train.
    """
    y, mean, unbiased = _BatchNormReLU.apply(x, bn.weight, bn.bias, weight,
                                             tuple(axes), group, counted)
    _update_running(bn, mean, unbiased)
    return y


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout: each element is kept with probability 1 - rate
    and scaled by 1 / (1 - rate), the mask drawn from ``generator`` (on
    x's device; None draws from the default generator).

    ``rows`` = (axis, start, total): x holds the rows [start, start +
    x.shape[axis]) of a batch of ``total`` along ``axis``, a data-parallel
    rank's share. The mask is drawn at the whole batch's shape and cut, so
    the ranks' generators stay in step and N ranks drop what one would."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape
    if rows is not None:
        axis, start, total = rows
        shape = shape[:axis] + (total,) + shape[axis + 1:]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if rows is not None:
        mask = mask.narrow(axis, start, x.shape[axis])
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
