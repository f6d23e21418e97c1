"""Train and eval steps (PyTorch).

Port of piano_a2s_tpu/train/step.py. One step is the forward, the
backward and an Adadelta update, with the reference's safeguards: the
gradients' global norm is clipped at 5.0, and the update is skipped when
the loss or that norm is not finite. The model, its BatchNorm buffers and
the optimizer are updated in place; a skipped step leaves all three as
they were. The stages of a step are marked with ``record_function``
(``train_step/frontend``, ``/forward``, ``/loss``, ``/backward``,
``/update``) for ``torch.profiler``; scripts/torch_train_breakdown.py
reads them.

Training on the card turns TF32 off (``make_train_steps`` calls
``use_full_float32``): the JAX package is the float32 reference.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..models.score_transcription import ScoreTranscription
from ..ops.vqt import VQTConfig, filters, get_vqt
from ..symbolic.vocab import LabelsMultiple
from ..utils.audio import PCM16_SCALE
from ..utils.device import resolve_device, use_full_float32
from .losses import (component_totals, fused_component_sums,
                     transcription_loss, transcription_loss_fused)

MAX_GRAD_NORM = 5.0

Batch = Dict[str, torch.Tensor]


class StepOutput(NamedTuple):
    loss: torch.Tensor
    components: Dict[str, torch.Tensor]
    grad_norm: Optional[torch.Tensor] = None  # before clipping


def make_optimizer(params, lr: float = 1.0, rho: float = 0.95,
                   eps: float = 1e-8) -> torch.optim.Adadelta:
    """Adadelta with the reference's settings (rho 0.95, eps 1e-8)."""
    return torch.optim.Adadelta(params, lr=lr, rho=rho, eps=eps)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (NewBob annealing)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def duration_fraction_table(vocab_size: int) -> np.ndarray:
    """(vocab,) float32: the whole-note fraction of each duration token id
    ("4" -> 1/4, "8." -> 1.5/8, tuplet values such as "12" -> 1/12), zero
    for pitch, separator and control ids: the guided attention's bar-time
    map (``ga_dur_frac``)."""
    table = np.zeros(vocab_size, np.float32)
    for tok, idx in LabelsMultiple(extended=True).labels_map.items():
        m = re.fullmatch(r"(\d+)(\.*)", tok)
        if m and idx < vocab_size:
            frac = 1.0 / max(int(m.group(1)), 1)
            table[idx] = frac * (2.0 - 0.5 ** len(m.group(2)))
    return table


def _ground_truth(batch: Batch):
    return (batch["time_sig"], batch["key"], batch["upper"],
            batch["upper_lengths"], batch["lower"], batch["lower_lengths"])


def _promote_staged(batch: Batch) -> Batch:
    """Undo reduced-precision staging of the spectrogram: float16 to
    float32, and uint8 (the log-VQT's [0, 1] range in 255 steps) to
    float32 / 255. Other dtypes pass unchanged."""
    spec = batch["spectrogram"]
    if spec.dtype == torch.float16:
        batch = dict(batch, spectrogram=spec.to(torch.float32))
    elif spec.dtype == torch.uint8:
        batch = dict(batch, spectrogram=spec.to(torch.float32) * (1.0 / 255.0))
    return batch


def make_audio_frontend(vqt_cfg: Optional[VQTConfig] = None,
                        max_frame_num: int = 1201, device="cuda"):
    """Batch prep for training from raw audio: the batch carries "audio"
    (B, samples), float32 or int16 PCM (divided by 32768 on the device),
    and gets "spectrogram" (B, 1, max_frame_num, bins), the log-VQT (the
    VQT kernel on the card) trimmed or zero-padded to max_frame_num, and
    "ga_content" (B,), the share of the frame window the clip's audio
    occupies, in [0.05, 1]. The spectrogram is an input: no gradient.
    ``device`` must be where the batches are; CUDA must exist if asked for.
    """
    vqt_cfg = vqt_cfg or VQTConfig()
    kernels = filters(vqt_cfg, resolve_device(device))

    def prep(batch: Batch) -> Batch:
        batch = dict(batch)
        audio = batch.pop("audio")
        if audio.dtype == torch.int16:
            audio = audio.to(torch.float32) / PCM16_SCALE
        n = audio.shape[-1]
        active = audio.abs() > 1e-4
        last = n - active.flip(-1).int().argmax(dim=-1)  # 1-based
        n_samples = torch.where(active.any(dim=-1), last, n)
        content = n_samples.double() / vqt_cfg.hop_length / max_frame_num
        batch["ga_content"] = content.clamp(0.05, 1.0).to(torch.float32)
        with torch.no_grad():
            spec = get_vqt(audio, kernels, vqt_cfg)       # (B, T, bins)
        t = spec.shape[1]
        if t >= max_frame_num:
            spec = spec[:, :max_frame_num]
        else:
            spec = torch.nn.functional.pad(spec, (0, 0, 0, max_frame_num - t))
        batch["spectrogram"] = spec[:, None]
        return batch

    return prep


def _buffers(model: torch.nn.Module):
    return [b for b in model.buffers() if b.is_floating_point()]


def _snapshot(model: torch.nn.Module):
    return [b.clone() for b in _buffers(model)]


def _restore(model: torch.nn.Module, saved) -> None:
    with torch.no_grad():
        for b, s in zip(_buffers(model), saved):
            b.copy_(s)


def _forward(model: ScoreTranscription, batch: Batch, generator, tf_ratio,
             ga_weight, ga_sigma, ga_dur_frac, ga_map, conv_dtype):
    return model(batch["spectrogram"], train=True,
                 ground_truth=_ground_truth(batch), tf_ratio=tf_ratio,
                 emit_full=False, sample_weight=batch.get("sample_weight"),
                 ga_sigma=(ga_sigma if ga_weight else 0.0),
                 ga_dur_frac=ga_dur_frac, ga_content=batch.get("ga_content"),
                 ga_map=ga_map, conv_dtype=conv_dtype, generator=generator)


def _clip_and_update(model: ScoreTranscription,
                     optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                     before) -> torch.Tensor:
    """Clip the gradients at a global norm of 5.0 (scaled by 5 / norm, as
    the JAX package does, without clip_grad_norm_'s + 1e-6), then step, or
    skip the step and restore the BatchNorm buffers to ``before`` when the
    loss or the norm is not finite. The finiteness check is the step's one
    read on the host. Returns the norm before clipping."""
    grads = []
    for p in model.parameters():
        if p.grad is None:  # JAX differentiates every leaf: zeros
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    gnorm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(gnorm > MAX_GRAD_NORM, MAX_GRAD_NORM / gnorm,
                        torch.ones_like(gnorm))
    torch._foreach_mul_(grads, scale)
    if bool(torch.isfinite(loss) & torch.isfinite(gnorm)):
        optimizer.step()
    else:
        _restore(model, before)
    return gnorm


def train_step(model: ScoreTranscription, optimizer: torch.optim.Optimizer,
               batch: Batch, generator: Optional[torch.Generator],
               tf_ratio: float, prep: Callable[[Batch], Batch] = _promote_staged,
               ga_weight: float = 0.0, ga_sigma: float = 0.15,
               ga_dur_frac=None, ga_map: str = "auto",
               conv_dtype: Optional[torch.dtype] = None) -> StepOutput:
    """One optimizer step on ``batch`` (tensors on the model's device).

    The fused-loss forward (emit_full=False) feeds the NLL with the
    log-probs at the targets only. ``prep`` maps the batch to the model's
    input (the staged-dtype promotion, or the audio frontend). Dropout
    masks and teacher-forcing coins come from ``generator``.
    ``conv_dtype`` (torch.bfloat16) runs the ConvStack in mixed precision
    (ScoreTranscription.forward); parameters, their gradients, the
    optimizer state and the BN buffers stay float32."""
    # A zero-width guide is no guide.
    ga_weight = ga_weight if ga_sigma > 0 else 0.0
    model.train()  # cuDNN's RNN backward needs the training mode
    with record_function("train_step/frontend"):
        batch = prep(batch)
    before = _snapshot(model)
    optimizer.zero_grad(set_to_none=True)
    with record_function("train_step/forward"):
        outs = _forward(model, batch, generator, tf_ratio, ga_weight,
                        ga_sigma, ga_dur_frac, ga_map, conv_dtype)
    with record_function("train_step/loss"):
        loss, comps = transcription_loss_fused(
            outs, batch, model.cfg.pad,
            sample_weight=batch.get("sample_weight"), ga_weight=ga_weight)
    with record_function("train_step/backward"):
        loss.backward()
    with record_function("train_step/update"):
        gnorm = _clip_and_update(model, optimizer, loss, before)
    return StepOutput(loss.detach(), {k: v.detach() for k, v in comps.items()},
                      gnorm)


def train_step_accum(model: ScoreTranscription,
                     optimizer: torch.optim.Optimizer, batch: Batch,
                     generator: Optional[torch.Generator], tf_ratio: float,
                     accum_steps: int,
                     prep: Callable[[Batch], Batch] = _promote_staged,
                     ga_weight: float = 0.0, ga_sigma: float = 0.15,
                     ga_dur_frac=None, ga_map: str = "auto",
                     conv_dtype: Optional[torch.dtype] = None) -> StepOutput:
    """One optimizer step on ``batch`` split into ``accum_steps``
    microbatches run one after another, so the activations are those of
    one microbatch.

    Exact decomposition: each microbatch's loss is its component
    numerators over the whole batch's totals (losses.component_totals), so
    the summed gradients are the full batch's. The one difference from a
    monolithic step is BatchNorm: each microbatch normalises by its own
    statistics, and the running statistics take exactly one momentum
    update per optimizer step, microbatch 0's; those of microbatches
    1..k-1 are thrown away. ``prep`` runs per microbatch."""
    ga_weight = ga_weight if ga_sigma > 0 else 0.0
    model.train()
    sw = batch.get("sample_weight")
    totals = component_totals(batch, model.cfg.pad, sample_weight=sw,
                              ga=bool(ga_weight))
    size = next(iter(batch.values())).shape[0]
    if size % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} does not divide the "
                         f"batch of {size}")
    micro = size // accum_steps
    before = _snapshot(model)
    optimizer.zero_grad(set_to_none=True)
    nums_acc: Dict[str, torch.Tensor] = {}
    after_first = None
    for m in range(accum_steps):
        with record_function("train_step/frontend"):
            mb = prep({k: v[m * micro:(m + 1) * micro]
                       for k, v in batch.items()})
        with record_function("train_step/forward"):
            outs = _forward(model, mb, generator, tf_ratio, ga_weight,
                            ga_sigma, ga_dur_frac, ga_map, conv_dtype)
        with record_function("train_step/loss"):
            nums = fused_component_sums(
                outs, mb, model.cfg.pad,
                sample_weight=mb.get("sample_weight"), ga_weight=ga_weight)
            part = sum(nums[k] / totals[k] for k in sorted(nums))
        with record_function("train_step/backward"):
            part.backward()
        for k, v in nums.items():
            nums_acc[k] = nums_acc.get(k, 0.0) + v.detach()
        if m == 0:
            after_first = _snapshot(model)
    _restore(model, after_first)
    comps = {k: nums_acc[k] / totals[k] for k in nums_acc}
    loss = sum(comps.values())
    with record_function("train_step/update"):
        gnorm = _clip_and_update(model, optimizer, loss, before)
    return StepOutput(loss, comps, gnorm)


@torch.no_grad()
def eval_step(model: ScoreTranscription, batch: Batch,
              prep: Callable[[Batch], Batch] = _promote_staged):
    """Free-running (greedy) inference and the loss of its outputs against
    the targets, as the reference evaluates. Returns (StepOutput,
    predictions dict)."""
    model.eval()
    batch = prep(batch)
    outs = model(batch["spectrogram"])
    ts_logp, key_logp, _, _, aux = outs
    loss, comps = transcription_loss(outs, batch, model.cfg.pad,
                                     sample_weight=batch.get("sample_weight"))
    preds = {"time_sig": ts_logp.argmax(dim=-1),
             "key": key_logp.argmax(dim=-1)}
    for k in ("upper_tokens", "lower_tokens", "upper_lengths",
              "lower_lengths"):
        preds[k] = aux[k]
    return StepOutput(loss, comps), preds


def batch_to_device(batch, device) -> Batch:
    """numpy arrays or tensors -> tensors on ``device`` (dtypes kept)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_steps(optimizer: torch.optim.Optimizer, accum_steps: int = 1,
                     from_audio: bool = False,
                     vqt_cfg: Optional[VQTConfig] = None,
                     max_frame_num: int = 1201, ga_weight: float = 0.0,
                     ga_sigma: float = 0.15, ga_dur_frac=None,
                     ga_map: str = "auto",
                     conv_dtype: Optional[torch.dtype] = None, device="cuda"):
    """(train_step(model, batch, generator, tf_ratio) -> StepOutput,
    eval_step(model, batch) -> (StepOutput, predictions)) for a model and
    ``optimizer`` on ``device``: the counterpart of the JAX package's
    make_jitted_steps, on one device (data parallel is a later slice).

    Batches may hold numpy arrays; they are moved to ``device``.
    accum_steps > 1 splits each batch into that many microbatches
    (train_step_accum). from_audio=True takes "audio" batches and runs the
    log-VQT frontend on the device inside both steps. conv_dtype=
    torch.bfloat16 trains the ConvStack in mixed precision; the eval step
    stays float32, as the JAX package's does. ``device`` defaults to CUDA
    and raises without it; on the card TF32 is turned off.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_full_float32()
    prep = (make_audio_frontend(vqt_cfg, max_frame_num, dev) if from_audio
            else _promote_staged)
    opts = dict(prep=prep, ga_weight=ga_weight, ga_sigma=ga_sigma,
                ga_dur_frac=ga_dur_frac, ga_map=ga_map, conv_dtype=conv_dtype)
    if accum_steps > 1:
        step = functools.partial(train_step_accum, accum_steps=accum_steps,
                                 **opts)
    else:
        step = functools.partial(train_step, **opts)

    def t_step(model, batch, generator, tf_ratio):
        return step(model, optimizer, batch_to_device(batch, dev), generator,
                    tf_ratio)

    def e_step(model, batch):
        return eval_step(model, batch_to_device(batch, dev), prep=prep)

    return t_step, e_step
