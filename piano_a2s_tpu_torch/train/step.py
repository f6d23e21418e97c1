"""Train and eval steps (PyTorch).

Port of piano_a2s_tpu/train/step.py. One step is the forward, the
backward and an Adadelta update, with the reference's safeguards: the
gradients' global norm is clipped at 5.0, and the update is skipped when
the loss or that norm is not finite. The model, its BatchNorm buffers and
the optimizer are updated in place; a skipped step leaves all three as
they were. The stages of a step are spans of ``utils.profiling``
(``train_step/frontend``, ``/forward``, ``/loss``, ``/backward``,
``/update``), ``record_function`` ranges while ``torch.profiler`` records;
the benchmark's ``train.forward_ms`` and ``train.backward_ms`` read them.

Training on the card turns TF32 off (``make_train_steps`` calls
``use_full_float32``): the JAX package is the float32 reference.

Data parallelism (``group``, a torch.distributed process group; the JAX
package's step jitted over a device mesh): every rank takes the global
batch's targets and sample weights, and either the global batch's feature
array or its own rows of it (per-host sharded loading); it computes its
rows (``parallel.step_rows``: its own, or stand-in rows that weigh 0 and
count in no statistic where it owns none of a microbatch) with the global
batch's
BatchNorm statistics, dropout masks and stop steps, all-reduces the sum of
the gradients as one flat buffer after the backward (after the last
microbatch) and the loss numerators, and divides by the totals of the
global targets. So the norm, the clip, the skip on a non-finite value, the
BatchNorm buffers and Adadelta agree on every rank, and equal one rank's
step on the whole batch. No DDP wrapper: the teacher-forced decode's ~2000
checkpointed steps read the same decoder weights, where DDP's reducer
expects one ready event per parameter per backward, and it would average
a loss that is already divided by global totals.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.score_transcription import ScoreTranscription
from ..ops.vqt import VQTConfig, filters, get_vqt
from ..parallel import all_reduce_, step_rows
from ..symbolic.vocab import LabelsMultiple
from ..utils.audio import PCM16_SCALE
from ..utils.device import resolve_device, use_full_float32
from ..utils.profiling import span
from .losses import (component_totals, full_component_sums,
                     fused_component_sums, transcription_loss,
                     transcription_loss_fused)

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
             ga_weight, ga_sigma, ga_dur_frac, ga_map, conv_dtype,
             group=None, rows=None):
    return model(batch["spectrogram"], train=True,
                 ground_truth=_ground_truth(batch), tf_ratio=tf_ratio,
                 emit_full=False, sample_weight=batch.get("sample_weight"),
                 ga_sigma=(ga_sigma if ga_weight else 0.0),
                 ga_dur_frac=ga_dur_frac, ga_content=batch.get("ga_content"),
                 ga_map=ga_map, conv_dtype=conv_dtype, generator=generator,
                 group=group, rows=rows, counted=batch.get("counted"))


def rank_rows(batch: Batch, accum_steps: int, group):
    """The rows this rank computes (``parallel.step_rows``) of every array
    of a global batch, and where they lie in each microbatch: (rows,
    (start, M)), the rows starting at offset ``start`` of every microbatch
    of M. An array that already holds only the rank's rows (the feature
    array of per-host sharded loading) passes as it is. Where the rank
    owns no row of a microbatch (M < N), its stand-in rows get a sample
    weight of 0 and a "counted" of 0, which keeps them out of the
    BatchNorm statistics' unweighted fallback too."""
    size = batch["time_sig"].shape[0]
    rows, start, owned = step_rows(dist.get_rank(group),
                                   dist.get_world_size(group), size,
                                   accum_steps)
    out = {}
    for k, v in batch.items():
        if v.shape[0] == size:
            out[k] = v[torch.as_tensor(rows, device=v.device)]
        elif v.shape[0] == len(rows):
            out[k] = v
        else:
            raise ValueError(f"{k!r} has {v.shape[0]} rows: neither the "
                             f"global batch's {size} nor this rank's "
                             f"{len(rows)}")
    if not owned:
        zeros = torch.zeros(len(rows), dtype=torch.float32,
                            device=out["time_sig"].device)
        out["sample_weight"], out["counted"] = zeros, zeros
    return out, (start, size // accum_steps)


def _clip_and_update(model: ScoreTranscription,
                     optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                     before, group=None) -> torch.Tensor:
    """Clip the gradients at a global norm of 5.0 (scaled by 5 / norm, as
    the JAX package does, without clip_grad_norm_'s + 1e-6), then step, or
    skip the step and restore the BatchNorm buffers to ``before`` when the
    loss or the norm is not finite. The finiteness check is the step's one
    read on the host. Returns the norm before clipping. ``group``: the
    gradients are first summed over the ranks, one flat all-reduce."""
    grads = []
    for p in model.parameters():
        if p.grad is None:  # JAX differentiates every leaf: zeros
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if group is not None:
        all_reduce_(grads, group)
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
               conv_dtype: Optional[torch.dtype] = None,
               group=None) -> StepOutput:
    """One optimizer step on ``batch`` (tensors on the model's device).

    The fused-loss forward (emit_full=False) feeds the NLL with the
    log-probs at the targets only. ``prep`` maps the batch to the model's
    input (the staged-dtype promotion, or the audio frontend). Dropout
    masks and teacher-forcing coins come from ``generator``.
    ``conv_dtype`` (torch.bfloat16) runs the ConvStack in mixed precision
    (ScoreTranscription.forward); parameters, their gradients, the
    optimizer state and the BN buffers stay float32. ``group``: a
    data-parallel step (train_step_accum with one microbatch).
    """
    if group is not None:
        return train_step_accum(model, optimizer, batch, generator, tf_ratio,
                                1, prep, ga_weight, ga_sigma, ga_dur_frac,
                                ga_map, conv_dtype, group)
    # A zero-width guide is no guide.
    ga_weight = ga_weight if ga_sigma > 0 else 0.0
    model.train()  # cuDNN's RNN backward needs the training mode
    with span("train_step/frontend"):
        batch = prep(batch)
    before = _snapshot(model)
    optimizer.zero_grad(set_to_none=True)
    with span("train_step/forward"):
        outs = _forward(model, batch, generator, tf_ratio, ga_weight,
                        ga_sigma, ga_dur_frac, ga_map, conv_dtype)
    with span("train_step/loss"):
        loss, comps = transcription_loss_fused(
            outs, batch, model.cfg.pad,
            sample_weight=batch.get("sample_weight"), ga_weight=ga_weight)
    with span("train_step/backward"):
        loss.backward()
    with span("train_step/update"):
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
                     conv_dtype: Optional[torch.dtype] = None,
                     group=None) -> StepOutput:
    """One optimizer step on ``batch`` split into ``accum_steps``
    microbatches run one after another, so the activations are those of
    one microbatch.

    Exact decomposition: each microbatch's loss is its component
    numerators over the whole batch's totals (losses.component_totals), so
    the summed gradients are the full batch's. The one difference from a
    monolithic step is BatchNorm: each microbatch normalises by its own
    statistics, and the running statistics take exactly one momentum
    update per optimizer step, microbatch 0's; those of microbatches
    1..k-1 are thrown away. ``prep`` runs per microbatch.

    ``group`` (data parallelism): ``batch`` is the global batch (its
    feature array may be this rank's rows already); microbatch m is the
    global rows [m B/A, (m+1) B/A), of which this rank computes its slice
    (``parallel.step_rows``; ValueError unless A and N each divide B). A
    rank that owns no row of a microbatch (B/A < N) computes a stand-in
    row that weighs 0 and counts in no BatchNorm statistic, so that it
    enters the same collectives as the others. The totals come from the global targets;
    the gradients and the numerators are summed over the ranks."""
    ga_weight = ga_weight if ga_sigma > 0 else 0.0
    model.train()
    sw = batch.get("sample_weight")
    totals = component_totals(batch, model.cfg.pad, sample_weight=sw,
                              ga=bool(ga_weight))
    size = batch["time_sig"].shape[0]
    rows = None
    if group is not None:
        batch, rows = rank_rows(batch, accum_steps, group)
        size = batch["time_sig"].shape[0]
    elif size % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} does not divide the "
                         f"batch of {size}")
    micro = size // accum_steps
    before = _snapshot(model)
    optimizer.zero_grad(set_to_none=True)
    nums_acc: Dict[str, torch.Tensor] = {}
    after_first = None
    for m in range(accum_steps):
        with span("train_step/frontend"):
            mb = prep({k: v[m * micro:(m + 1) * micro]
                       for k, v in batch.items()})
        with span("train_step/forward"):
            outs = _forward(model, mb, generator, tf_ratio, ga_weight,
                            ga_sigma, ga_dur_frac, ga_map, conv_dtype, group,
                            rows)
        with span("train_step/loss"):
            nums = fused_component_sums(
                outs, mb, model.cfg.pad,
                sample_weight=mb.get("sample_weight"), ga_weight=ga_weight)
            part = sum(nums[k] / totals[k] for k in sorted(nums))
        with span("train_step/backward"):
            part.backward()
        for k, v in nums.items():
            nums_acc[k] = nums_acc.get(k, 0.0) + v.detach()
        if m == 0:
            after_first = _snapshot(model)
    _restore(model, after_first)
    if group is not None:
        all_reduce_(list(nums_acc.values()), group)
    comps = {k: nums_acc[k] / totals[k] for k in nums_acc}
    loss = sum(comps.values())
    with span("train_step/update"):
        gnorm = _clip_and_update(model, optimizer, loss, before, group)
    return StepOutput(loss, comps, gnorm)


@torch.no_grad()
def eval_step(model: ScoreTranscription, batch: Batch,
              prep: Callable[[Batch], Batch] = _promote_staged, group=None,
              decode_chunk=None):
    """Free-running (greedy) inference and the loss of its outputs against
    the targets, as the reference evaluates. Returns (StepOutput,
    predictions dict). ``decode_chunk``: the decode's stop groups
    (ScoreTranscription.forward); None, the reference's one group, by
    default, and ignored under ``group``, as the JAX package's eval step
    ignores it under a mesh.

    ``group`` (data parallelism, a global batch): each rank decodes its
    rows, all ranks stop together (the JAX package's eval is one loop over
    the global batch), and every rank gets the global batch's predictions
    and loss: its rows go into zero-filled global buffers and its loss
    numerators are summed over the ranks, then divided by the totals of
    the global targets."""
    model.eval()
    if group is not None:
        return _eval_step_dp(model, batch, prep, group)
    batch = prep(batch)
    outs = model(batch["spectrogram"], decode_chunk=decode_chunk)
    loss, comps = transcription_loss(outs, batch, model.cfg.pad,
                                     sample_weight=batch.get("sample_weight"))
    return StepOutput(loss, comps), _predictions(outs)


def _predictions(outs) -> Dict[str, torch.Tensor]:
    ts_logp, key_logp, _, _, aux = outs
    preds = {"time_sig": ts_logp.argmax(dim=-1),
             "key": key_logp.argmax(dim=-1)}
    for k in ("upper_tokens", "lower_tokens", "upper_lengths",
              "lower_lengths"):
        preds[k] = aux[k]
    return preds


def _eval_step_dp(model: ScoreTranscription, batch: Batch, prep, group):
    size = batch["time_sig"].shape[0]
    local = prep(rank_rows(batch, 1, group)[0])
    outs = model(local["spectrogram"], group=group)
    nums = full_component_sums(outs, local, model.cfg.pad,
                               sample_weight=local.get("sample_weight"))
    totals = component_totals(batch, model.cfg.pad,
                              sample_weight=batch.get("sample_weight"))
    rows = torch.as_tensor(step_rows(dist.get_rank(group),
                                     dist.get_world_size(group), size)[0],
                           device=outs[0].device)
    preds = {}
    for k, v in _predictions(outs).items():
        preds[k] = v.new_zeros((size,) + v.shape[1:])
        preds[k][rows] = v
    all_reduce_(list(nums.values()) + list(preds.values()), group)
    comps = {k: nums[k] / totals[k] for k in nums}
    return StepOutput(sum(comps.values()), comps), preds


def batch_to_device(batch, device) -> Batch:
    """numpy arrays or tensors -> tensors on ``device`` (dtypes kept)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_steps(optimizer: torch.optim.Optimizer, accum_steps: int = 1,
                     from_audio: bool = False,
                     vqt_cfg: Optional[VQTConfig] = None,
                     max_frame_num: int = 1201, ga_weight: float = 0.0,
                     ga_sigma: float = 0.15, ga_dur_frac=None,
                     ga_map: str = "auto",
                     conv_dtype: Optional[torch.dtype] = None, device="cuda",
                     group=None, eval_decode_chunk=None):
    """(train_step(model, batch, generator, tf_ratio) -> StepOutput,
    eval_step(model, batch) -> (StepOutput, predictions)) for a model and
    ``optimizer`` on ``device``: the counterpart of the JAX package's
    make_jitted_steps. ``group`` (a torch.distributed process group) makes
    both steps data-parallel over its ranks, one per device, each given the
    global batch (see the module docstring); the model's weights must
    agree on every rank (parallel.broadcast_module_).

    Batches may hold numpy arrays; they are moved to ``device``.
    accum_steps > 1 splits each batch into that many microbatches
    (train_step_accum). from_audio=True takes "audio" batches and runs the
    log-VQT frontend on the device inside both steps. conv_dtype=
    torch.bfloat16 trains the ConvStack in mixed precision; the eval step
    stays float32, as the JAX package's does. ``eval_decode_chunk``: the
    eval step's stop groups (eval_step's decode_chunk; None by default and
    under ``group``). ``device`` defaults to CUDA and raises without it; on
    the card TF32 is turned off.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_full_float32()
    prep = (make_audio_frontend(vqt_cfg, max_frame_num, dev) if from_audio
            else _promote_staged)
    opts = dict(prep=prep, ga_weight=ga_weight, ga_sigma=ga_sigma,
                ga_dur_frac=ga_dur_frac, ga_map=ga_map, conv_dtype=conv_dtype,
                group=group)
    if accum_steps > 1:
        step = functools.partial(train_step_accum, accum_steps=accum_steps,
                                 **opts)
    else:
        step = functools.partial(train_step, **opts)

    def t_step(model, batch, generator, tf_ratio):
        return step(model, optimizer, batch_to_device(batch, dev), generator,
                    tf_ratio)

    def e_step(model, batch):
        return eval_step(model, batch_to_device(batch, dev), prep=prep,
                         group=group, decode_chunk=eval_decode_chunk)

    return t_step, e_step
