"""Loss functions: the 4-way NLL sum with pad masking (PyTorch).

Port of piano_a2s_tpu/train/losses.py. torch.nn.NLLLoss semantics: the mean
over non-ignored targets; the staff losses ignore the <pad> index (147).
``sample_weight`` (B,) weights whole batch items (0 drops the padding
duplicates of a last batch from every mean).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _weight_mask(mask: torch.Tensor,
                 sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Apply optional per-sample (leading-axis) weights to a mask."""
    if sample_weight is None:
        return mask
    w = torch.as_tensor(sample_weight, dtype=mask.dtype, device=mask.device)
    return mask * w.reshape(w.shape + (1,) * (mask.dim() - 1))


def _pick(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return log_probs.gather(-1, targets.long()[..., None])[..., 0]


def nll(log_probs: torch.Tensor, targets: torch.Tensor,
        ignore_index: Optional[int] = None,
        sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Negative log likelihood, the mean over non-ignored targets.
    log_probs (..., C); targets (...) int."""
    picked = _pick(log_probs, targets)
    if ignore_index is None:
        mask = torch.ones_like(picked)
    else:
        mask = (targets != ignore_index).to(log_probs.dtype)
    mask = _weight_mask(mask, sample_weight)
    return -(picked * mask).sum() / mask.sum().clamp(min=1.0)


def transcription_loss(outputs, batch, pad_index: int = 147,
                       sample_weight=None):
    """Total loss = time + key + upper + lower NLL, from full
    distributions. Returns (loss, components dict)."""
    ts_logp, key_logp, up_logp, low_logp = outputs[:4]
    w = sample_weight
    comps = {
        "time_loss": nll(ts_logp, batch["time_sig"], sample_weight=w),
        "key_loss": nll(key_logp, batch["key"], sample_weight=w),
        "upper_loss": nll(up_logp, batch["upper"], ignore_index=pad_index,
                          sample_weight=w),
        "lower_loss": nll(low_logp, batch["lower"], ignore_index=pad_index,
                          sample_weight=w)}
    loss = (comps["time_loss"] + comps["key_loss"] + comps["upper_loss"]
            + comps["lower_loss"])
    return loss, comps


def _masked_mean_neg(picked: torch.Tensor, targets: torch.Tensor,
                     pad_index: int, sample_weight=None) -> torch.Tensor:
    mask = _weight_mask((targets != pad_index).to(picked.dtype),
                        sample_weight)
    return -(picked * mask).sum() / mask.sum().clamp(min=1.0)


def transcription_loss_fused(outputs, batch, pad_index: int = 147,
                             sample_weight=None, ga_weight: float = 0.0):
    """The same loss from the log-probs picked at the target tokens
    (forward(emit_full=False): staff outputs (B, bars, T)), so the
    (B, bars, T, V) distributions never exist.

    ga_weight > 0 adds the guided-attention penalty: the mean, per non-pad
    note step of both staves, of the attention mass outside the guide,
    from the forward's aux["ga_num"]."""
    ts_logp, key_logp, up_picked, low_picked = outputs[:4]
    w = sample_weight
    comps = {
        "time_loss": nll(ts_logp, batch["time_sig"], sample_weight=w),
        "key_loss": nll(key_logp, batch["key"], sample_weight=w),
        "upper_loss": _masked_mean_neg(up_picked, batch["upper"], pad_index,
                                       w),
        "lower_loss": _masked_mean_neg(low_picked, batch["lower"],
                                       pad_index, w)}
    loss = (comps["time_loss"] + comps["key_loss"] + comps["upper_loss"]
            + comps["lower_loss"])
    if ga_weight:
        comps["ga_loss"] = (_ga_numerator(outputs, w, ga_weight)
                            / _ga_total(batch, pad_index, w))
        loss = loss + comps["ga_loss"]
    return loss, comps


def _ga_numerator(outputs, sample_weight, ga_weight: float) -> torch.Tensor:
    """Weighted guided-attention penalty sum for one (micro)batch."""
    per_clip = outputs[4]["ga_num"].sum(dim=(1, 2))  # (B, bars, 2) -> (B,)
    if sample_weight is not None:
        per_clip = per_clip * torch.as_tensor(sample_weight,
                                              device=per_clip.device)
    return ga_weight * per_clip.sum()


def _ga_total(batch, pad_index: int, sample_weight) -> torch.Tensor:
    """The guide's denominator: non-pad note steps over both staves, from
    the targets alone."""
    def total(targets):
        mask = (targets != pad_index).to(torch.float32)
        return _weight_mask(mask, sample_weight).sum()
    return (total(batch["upper"]) + total(batch["lower"])).clamp(min=1.0)


# --- gradient-accumulation decomposition ----------------------------------
#
# Each component loss is a masked mean, -sum(picked * mask) / sum(mask),
# whose denominator depends only on the targets and sample weights. So the
# full-batch loss is sum_c (sum_m numerator_c(micro_m)) / total_c(batch):
# microbatches accumulate numerators and their gradients, and the division
# by the batch's totals gives the full-batch loss and gradient exactly.


def fused_component_sums(outputs, batch, pad_index: int = 147,
                         sample_weight=None,
                         ga_weight: float = 0.0) -> Dict[str, torch.Tensor]:
    """Per-component NLL numerators (-sum picked * mask) of one
    microbatch, from the fused forward's picked log-probs. ga_weight > 0
    adds the guided-attention numerator ("ga_loss")."""
    ts_logp, key_logp, up_picked, low_picked = outputs[:4]
    w = sample_weight

    def pick_sum(log_probs, targets):
        picked = _pick(log_probs, targets)
        return -(picked * _weight_mask(torch.ones_like(picked), w)).sum()

    def masked_sum(picked, targets):
        mask = _weight_mask((targets != pad_index).to(picked.dtype), w)
        return -(picked * mask).sum()

    nums = {"time_loss": pick_sum(ts_logp, batch["time_sig"]),
            "key_loss": pick_sum(key_logp, batch["key"]),
            "upper_loss": masked_sum(up_picked, batch["upper"]),
            "lower_loss": masked_sum(low_picked, batch["lower"])}
    if ga_weight:
        nums["ga_loss"] = _ga_numerator(outputs, w, ga_weight)
    return nums


def component_totals(batch, pad_index: int = 147, sample_weight=None,
                     ga: bool = False) -> Dict[str, torch.Tensor]:
    """The mean denominators of the whole batch, from the targets alone.
    ga=True adds the guided-attention denominator."""
    w = sample_weight

    def total(mask):
        return _weight_mask(mask, w).sum().clamp(min=1.0)

    ones_bars = torch.ones(batch["time_sig"].shape, dtype=torch.float32,
                           device=batch["time_sig"].device)
    totals = {
        "time_loss": total(ones_bars),
        "key_loss": total(ones_bars),
        "upper_loss": total((batch["upper"] != pad_index).to(torch.float32)),
        "lower_loss": total((batch["lower"] != pad_index).to(torch.float32)),
    }
    if ga:
        totals["ga_loss"] = _ga_total(batch, pad_index, w)
    return totals
