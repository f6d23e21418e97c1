"""Training and evaluation harness (PyTorch): the port of
piano_a2s_tpu/train/harness.py, the reference's SpeechBrain
``ASR(sb.Brain)`` (reference: pretrain.py:31-214, finetune.py).

Epoch loop with teacher-forcing decay, the train and eval steps of
train/step.py, free-running validation with WER and macro-F1, NewBob
learning-rate annealing on WER, keep-best-WER checkpoints with resume and
the finetune warm start, per-clip result JSONs and the plain-text train
log. One process drives one device; the host loads and stages numpy
batches, the steps move them to the device.

Data parallelism (``use_mesh=True``, the JAX Trainer's device mesh): one
process per device in a torch.distributed group (torchrun,
parallel.distributed_init). Every rank builds the same global batch plan
and targets, checked on the first batch (``parallel.assert_ranks_agree``),
uploads only its rows of the feature array, and runs the data-parallel
steps of train/step.py; rank 0 alone writes checkpoints, result JSONs, the
train log and step times.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel
from ..config import ExperimentConfig
from ..data.datasets import load_time_signatures
from ..models.convert import init_state_dict
from ..models.score_transcription import ScoreTranscription
from ..utils.audio import to_pcm16
from ..utils.device import resolve_device
from ..utils.profiling import StepTimer, trace
from .checkpoint import Checkpointer
from .logger import FileTrainLogger
from .metrics import calculate_f1, calculate_wer, unpad
from .schedulers import NewBobScheduler, teacher_forcing_ratio
from .step import (duration_fraction_table, make_optimizer, make_train_steps,
                   set_learning_rate)

# Batch keys the host keeps: they never go to the device.
HOST_KEYS = ("names", "versions", "n_real", "local_rows")


def _stage_cast(dtype, key: str = "spectrogram"):
    """Loader-thread staging cast for upload_dtype (see Trainer.fit).

    uint8 staging quantizes the [0,1] log-VQT to 1/255 steps (0.31 dB on
    the 80 dB scale); the clip guards degenerate inputs. int16 staging
    (audio batches) uses the PCM16 scale the device conversion inverts
    exactly (train/step.make_audio_frontend). The train step converts
    staged spectrograms back to float32 (train/step._promote_staged)."""
    def transform(batch):
        batch = dict(batch)
        a = batch[key]
        if dtype == np.uint8:
            a = np.round(np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
        elif dtype == np.int16:
            if a.dtype != np.int16:
                a = to_pcm16(a)
        else:
            a = np.asarray(a, dtype)
        batch[key] = a
        return batch
    return transform


class Trainer:
    """The training harness on ``device`` (default CUDA; raises without
    it). Weights come from ``init_state_dict(cfg, exp.seed)``, or from
    ``state_dict`` (e.g. weights converted from the JAX package).

    ``use_mesh=True``: data-parallel over the initialised process group
    (parallel.distributed_init), on this rank's device (a bare "cuda" is
    cuda:LOCAL_RANK), with rank 0's weights broadcast after construction
    and after every restore. ``exp.batch_size`` is the global batch."""

    def __init__(self, exp: ExperimentConfig, device="cuda",
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 use_mesh: bool = False):
        self.exp = exp
        self.cfg = exp.model_config()
        self.group = None
        if use_mesh:
            if not parallel.is_initialized():
                raise ValueError(
                    "use_mesh=True (data-parallel training) needs an "
                    "initialised process group: run under torchrun and call "
                    "piano_a2s_tpu_torch.parallel.distributed_init() first")
            self.group = dist.group.WORLD
            self.device = parallel.local_device(device)
        else:
            self.device = resolve_device(device)
        # Mixed-precision ConvStack training (extras `train_dtype:
        # bfloat16`): the conv stack computes and keeps its activations in
        # bf16, its BatchNorm statistics in float32; the parameters, the
        # decoder and the losses stay float32.
        self.conv_dtype = None
        train_dtype = exp.extras.get("train_dtype")
        if train_dtype not in (None, "", "float32", "f32"):
            try:
                self.conv_dtype = {"bfloat16": torch.bfloat16,
                                   "bf16": torch.bfloat16}[str(train_dtype)]
            except KeyError:
                raise ValueError(
                    f"train_dtype={train_dtype!r}: supported values are "
                    f"'bfloat16' (or 'float32' for the default)") from None
        # Stop groups of the validation decode (extras
        # `eval_decode_chunk: auto` or an int): off by default, since the
        # decode's batch-coupled early exit then differs from the
        # reference's one group per eval batch; ignored under data
        # parallelism (train/step.py's eval_step).
        self.eval_decode_chunk = exp.extras.get("eval_decode_chunk")
        if self.eval_decode_chunk not in (None, "auto"):
            self.eval_decode_chunk = int(self.eval_decode_chunk)

        self.model = ScoreTranscription(self.cfg)
        self.model.load_state_dict(
            state_dict if state_dict is not None
            else init_state_dict(self.cfg, exp.seed), strict=True)
        self.model.to(self.device)
        if self.group is not None:
            parallel.broadcast_module_(self.model, group=self.group)
        self.optimizer = self._new_optimizer()
        # Gradient accumulation: microbatch the train step so that its
        # activations are those of one microbatch.
        self.accum_steps = int(exp.extras.get("accum_steps", 1))
        if exp.batch_size % max(self.accum_steps, 1):
            raise ValueError(
                f"accum_steps={self.accum_steps} must divide "
                f"batch_size={exp.batch_size}")
        # Training from raw audio (extras `input_features: audio`): the
        # log-VQT frontend (the VQT kernel on the card) runs inside the
        # train and eval steps; the datasets must be built with the same
        # input_features so that batches carry "audio".
        feats = str(exp.extras.get("input_features", "spectrogram"))
        if feats not in ("spectrogram", "audio"):
            raise ValueError(f"input_features={feats!r}: "
                             f"'spectrogram' or 'audio'")
        self.from_audio = feats == "audio"
        self.feature_key = feats
        # Reduced-precision staging of the train batches' feature array
        # (extras `upload_dtype`): it changes what a config trains on
        # (uint8 quantizes the spectrogram), so it is honoured and
        # validated as the JAX package does.
        self.upload_dtype = None
        if self.from_audio:
            # Audio batches default to int16 staging: exact for 16-bit PCM
            # sources, half the bytes.
            choice = exp.extras.get("upload_dtype", "int16")
            try:
                self.upload_dtype = {
                    "float32": None, "f32": None,
                    "int16": np.int16, "i16": np.int16}[str(choice)]
            except KeyError:
                raise ValueError(
                    f"upload_dtype={choice!r}: audio batches support "
                    f"'int16' or 'float32'") from None
        else:
            # Spectrogram batches: uint8 under bf16 training (its 1/255
            # steps are about the size of bf16's own rounding near 1, where
            # the conv stack casts them), float32 otherwise, unless asked
            # for (legacy `upload_f16: true/false` maps to float16/float32).
            choice = exp.extras.get("upload_dtype")
            if choice is None:
                legacy = exp.extras.get("upload_f16")
                if legacy is not None:
                    choice = "float16" if legacy else "float32"
                elif self.conv_dtype is not None:
                    choice = "uint8"
            if choice is not None:
                try:
                    self.upload_dtype = {
                        "float32": None, "f32": None,
                        "float16": np.float16, "f16": np.float16,
                        "uint8": np.uint8, "u8": np.uint8}[str(choice)]
                except KeyError:
                    raise ValueError(
                        f"upload_dtype={choice!r}: supported values are "
                        f"'uint8', 'float16', 'float32'") from None
        # Guided attention (extras `guided_attention: <weight>`): an opt-in
        # diagonal attention prior on the note decoders; off by default.
        self.ga_weight = float(exp.extras.get("guided_attention", 0.0))
        self.ga_sigma = float(exp.extras.get("guided_attention_sigma",
                                             0.15))
        if self.ga_weight > 0 and self.ga_sigma <= 0:
            raise ValueError(
                "extras guided_attention > 0 requires "
                "guided_attention_sigma > 0 (a zero-width guide is no "
                f"guide); got sigma={self.ga_sigma}")
        self.ga_dur_frac = (duration_fraction_table(self.cfg.vocab_size)
                            if self.ga_weight else None)
        self.ga_map = str(exp.extras.get("guided_attention_map", "auto"))
        if self.ga_map not in ("auto", "events", "tokens"):
            raise ValueError(
                "extras guided_attention_map must be auto|events|tokens; "
                f"got {self.ga_map!r}")
        self.train_step, self.eval_step = make_train_steps(
            self.optimizer, accum_steps=self.accum_steps,
            from_audio=self.from_audio, vqt_cfg=exp.vqt_config(),
            max_frame_num=exp.max_frame_num, ga_weight=self.ga_weight,
            ga_sigma=self.ga_sigma, ga_dur_frac=self.ga_dur_frac,
            ga_map=self.ga_map, conv_dtype=self.conv_dtype,
            device=self.device, group=self.group,
            eval_decode_chunk=self.eval_decode_chunk)
        # Length bucketing: a batch whose longest target is far below the
        # caps decodes to a shorter width (rounded up to bucket_tokens);
        # exact, as the cut positions are all <pad>. 0 disables it.
        self.bucket_tokens = int(exp.extras.get("bucket_tokens", 64))
        # Profiling (--profile / extras profile): per-step timing, which
        # syncs the device every step, and a torch.profiler trace of the
        # first profile_trace_steps steps.
        self.profile = bool(exp.extras.get("profile", False))
        self.profile_trace_steps = int(
            exp.extras.get("profile_trace_steps", 3))
        self.step_timer = StepTimer() if self.profile else None

        self.scheduler = NewBobScheduler(
            initial_value=exp.lr, annealing_factor=exp.annealing_factor,
            improvement_threshold=exp.improvement_threshold,
            patient=exp.patient)
        # Rank 0 alone writes the checkpoints, results and logs (all ranks
        # compute the same). Every rank must build the same global batches
        # (same loader seed and dataset listing): checked on the first.
        self.is_main_process = (self.group is None
                                or dist.get_rank(self.group) == 0)
        self._batch_contract_ok = (self.group is None
                                   or dist.get_world_size(self.group) == 1)
        self.checkpointer = Checkpointer(exp.save_folder)
        self.logger = FileTrainLogger(exp.train_log)
        self.start_epoch = 1
        self.global_step = 0
        self.train_stats: Dict[str, Any] = {"loss": -1}
        # Dropout masks and teacher-forcing coins; not checkpointed.
        self.generator = torch.Generator(self.device).manual_seed(exp.seed)

    # ------------------------------------------------------------------ util

    def _new_optimizer(self) -> torch.optim.Adadelta:
        return make_optimizer(
            self.model.parameters(), lr=self.exp.lr,
            rho=float(self.exp.extras.get("rho", 0.95)),
            eps=float(self.exp.extras.get("eps", 1e-8)))

    def _device_batch(self, batch: Dict[str, Any],
                      train: bool = False) -> Dict[str, Any]:
        """The arrays a step takes: the host-only keys dropped, the staging
        cast applied to train batches, and "sample_weight" zero on the
        final batch's padding rows (they add nothing to the losses, the
        gradients or the BatchNorm statistics).

        Data parallel: the targets and weights stay global, the feature
        array is cut to the rows this rank computes (``parallel.step_rows``:
        its own, or stand-ins where it owns none of a microbatch), or, from
        per-host sharded loading, its rows are checked against them."""
        local_rows = batch.get("local_rows")
        if local_rows is not None and self.group is None:
            raise ValueError("per-host sharded batches need data-parallel "
                             "training (Trainer(use_mesh=True))")
        dev = {k: v for k, v in batch.items() if k not in HOST_KEYS}
        if train and self.upload_dtype is not None:
            # Eval batches stay as loaded: validation WER is a parity
            # surface. No-op when the loader's transform already cast it.
            k = self.feature_key
            if dev[k].dtype != self.upload_dtype:
                dev[k] = _stage_cast(self.upload_dtype, k)({k: dev[k]})[k]
        b = len(batch["names"])
        n_real = int(batch.get("n_real", b))
        weights = np.zeros(b, np.float32)
        weights[:n_real] = 1.0
        dev["sample_weight"] = weights
        if self.group is None:
            return dev
        if not self._batch_contract_ok:
            if local_rows is None:
                parallel.assert_ranks_agree(dev, self.group)
            else:
                # Sharded loading: the feature arrays differ by design; the
                # contract is the global plan, targets and weights.
                meta = {k: v for k, v in dev.items()
                        if k != self.feature_key}
                for k in ("names", "versions"):
                    meta[k] = np.frombuffer(
                        "\x00".join(map(str, batch[k])).encode(), np.uint8)
                parallel.assert_ranks_agree(meta, self.group)
            self._batch_contract_ok = True
        r = dist.get_rank(self.group)
        rows = parallel.step_rows(r, dist.get_world_size(self.group), b,
                                  self.accum_steps if train else 1)[0]
        k = self.feature_key
        if local_rows is None:
            dev[k] = dev[k][rows]
        elif not np.array_equal(local_rows, rows):
            raise ValueError(
                f"loader shard rows {np.asarray(local_rows).tolist()} != "
                f"rows {rows.tolist()} owned by rank {r}: the DataLoader's "
                f"shard=(rank, world) and accum_steps must follow the "
                f"process group and the Trainer's accum_steps")
        return dev

    def barrier(self, tag: str) -> None:
        """Cross-process rendezvous (nothing to wait for without a group):
        where ranks must not read checkpoint state that rank 0 may still be
        writing."""
        if self.group is not None:
            parallel.barrier(self.group)

    # ------------------------------------------------------------ checkpoint

    def _trees(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def _host_state(self, epoch: int):
        return {"scheduler": self.scheduler.state_dict(), "epoch": epoch,
                "global_step": self.global_step}

    def save_checkpoint(self, epoch: int, meta: Dict[str, Any]):
        if not self.is_main_process:
            return
        self.checkpointer.save_and_keep_only(
            self._trees(), meta, self._host_state(epoch), min_keys=("WER",))

    def restore(self, path: str):
        """Load a checkpoint: weights and BatchNorm buffers, the optimizer
        (a fresh Adadelta at exp.lr when the checkpoint was imported as a
        warm start: the reference's recoverables exclude the optimizer),
        the scheduler and the epoch and step counters."""
        trees, host_state, meta = self.checkpointer.load(path)
        self.model.load_state_dict(trees["model"], strict=True)
        if host_state.get("fresh_optimizer"):
            self.optimizer.load_state_dict(
                self._new_optimizer().state_dict())
        else:
            self.optimizer.load_state_dict(trees["optimizer"])
        if host_state.get("scheduler"):
            self.scheduler.load_state_dict(host_state["scheduler"])
        self.start_epoch = int(host_state.get("epoch", 0)) + 1
        self.global_step = int(host_state.get("global_step", 0))
        if self.group is not None:
            parallel.broadcast_module_(self.model, group=self.group)
        return meta

    def _agreed(self, path: Optional[str]) -> Optional[str]:
        """Rank 0's choice of checkpoint on every rank (restore issues a
        broadcast, so no rank may decide from its own view of the disk)."""
        if self.group is None:
            return path
        return parallel.broadcast_path(path, self.group)

    def try_resume(self) -> bool:
        path = self._agreed(self.checkpointer.latest_path())
        if path is None:
            return False
        self.restore(path)
        return True

    # ------------------------------------------------------------ bucketing

    def _bucketed(self, batch):
        """The batch with its target arrays cut to the decode width that
        covers its longest target plus EOS, rounded up to bucket_tokens
        (at most the caps). The teacher-forced decode runs to the targets'
        width. Exact: the cut positions are all <pad>."""
        if self.bucket_tokens <= 0:
            return batch
        q = self.bucket_tokens
        t_up, t_low = self.cfg.max_length

        def bucket(lengths, cap):
            need = int(np.max(lengths)) + 1  # + EOS position
            return min(-(-need // q) * q, cap)

        bu = bucket(batch["upper_lengths"], t_up)
        bl = bucket(batch["lower_lengths"], t_low)
        if (bu, bl) == (t_up, t_low):
            return batch
        batch = dict(batch)
        batch["upper"] = batch["upper"][:, :, :bu]
        batch["lower"] = batch["lower"][:, :, :bl]
        return batch

    # ------------------------------------------------------------------ fit

    def fit(self, train_loader, valid_loader,
            epochs: Optional[int] = None) -> None:
        epochs = epochs or self.exp.number_of_epochs
        if (self.upload_dtype is not None
                and getattr(train_loader, "transform", "absent") is None):
            # Cast where batches are built (the loader's prefetch thread),
            # so that it overlaps the device's work.
            train_loader.transform = _stage_cast(self.upload_dtype,
                                                 self.feature_key)
        self.try_resume()
        for epoch in range(self.start_epoch, epochs + 1):
            tf = teacher_forcing_ratio(self.exp.teacher_forcing_ratio,
                                       self.exp.teacher_forcing_decay, epoch)
            t0 = time.time()
            outs = []
            epoch_mark = (self.step_timer.mark()
                          if self.step_timer is not None else None)

            def one_step(batch):
                dev = self._device_batch(self._bucketed(batch), train=True)
                if self.step_timer is None:
                    out = self.train_step(self.model, dev, self.generator, tf)
                else:
                    with self.step_timer.time("train_step") as c:
                        out = self.train_step(self.model, dev,
                                              self.generator, tf)
                        c["loss"] = out.loss
                self.global_step += 1
                # The losses stay on the device during the epoch: one
                # transfer at its end.
                outs.append(out)

            batches = iter(train_loader)
            if (self.profile and epoch == self.start_epoch
                    and self.profile_trace_steps > 0
                    and self.is_main_process):
                with trace(os.path.join(self.exp.output_folder, "profile")):
                    for batch in itertools.islice(
                            batches, self.profile_trace_steps):
                        one_step(batch)
            for batch in batches:
                one_step(batch)
            self.train_stats = self._epoch_stats(outs)
            self.train_stats["teacher_forcing_ratio"] = tf

            stage_stats = self._eval_stage(valid_loader, "valid", epoch)
            old_lr, new_lr = self.scheduler(stage_stats["WER"])
            set_learning_rate(self.optimizer, new_lr)
            stats_meta = {"epoch": epoch, "lr": old_lr,
                          "epoch_time": round(time.time() - t0, 1)}
            if self.step_timer is not None:
                # This epoch's mean only.
                summ = self.step_timer.summary(
                    since=epoch_mark).get("train_step")
                if summ:
                    stats_meta["step_ms"] = round(summ["mean_s"] * 1e3, 2)
            if self.is_main_process:
                self.logger.log_stats(stats_meta=stats_meta,
                                      train_stats=self.train_stats,
                                      valid_stats=stage_stats)
            self.save_checkpoint(epoch, {"loss": stage_stats["loss"],
                                         "WER": stage_stats["WER"]})
        if self.step_timer is not None and self.is_main_process:
            prof_dir = os.path.join(self.exp.output_folder, "profile")
            os.makedirs(prof_dir, exist_ok=True)
            with open(os.path.join(prof_dir, "step_times.json"), "w") as f:
                json.dump(self.step_timer.summary(), f, indent=2)

    @staticmethod
    def _epoch_stats(outs) -> Dict[str, float]:
        """Mean loss and loss components over an epoch's step outputs,
        fetched from the device in one transfer."""
        if not outs:
            return {"loss": -1.0}
        # Sorted, as the JAX package's components come back from the device.
        keys = sorted(outs[0].components)
        table = torch.stack([torch.stack([o.loss] + [o.components[k]
                                                     for k in keys])
                             for o in outs]).cpu().numpy()
        # As the JAX package averages them: the loss as Python floats, the
        # components in float32.
        stats = {"loss": float(np.mean(table[:, 0].tolist()))}
        for i, k in enumerate(keys):
            stats[k] = float(np.mean(table[:, i + 1]))
        return stats

    # ------------------------------------------------------------- evaluate

    def evaluate(self, test_loader, min_key: str = "WER"):
        self.barrier("evaluate:before-restore")
        path = self._agreed(self.checkpointer.best_path(min_key))
        if path is not None:
            self.restore(path)
        stage_stats = self._eval_stage(test_loader, "test", epoch=None)
        if self.is_main_process:
            self.logger.log_stats(stats_meta={"stage": "test"},
                                  test_stats=stage_stats)
        return stage_stats

    # ------------------------------------------------------------ eval core

    def _eval_stage(self, loader, split: str, epoch):
        """Free-running decode over the loader; WER/F1; result JSONs
        (reference: pretrain.py:95-214). Returns the stage stats dict."""
        upper_pred, upper_tgt = {}, {}
        lower_pred, lower_tgt = {}, {}
        key_pred, key_tgt = {}, {}
        ts_pred, ts_tgt = {}, {}
        losses, comps_hist = [], []
        time_sig_list = load_time_signatures()

        for batch in loader:
            out, preds = self.eval_step(self.model, self._device_batch(batch))
            preds = {k: v.cpu().numpy() for k, v in preds.items()}
            losses.append(float(out.loss))
            comps_hist.append({k: float(v)
                               for k, v in sorted(out.components.items())})
            n_real = batch.get("n_real", len(batch["names"]))
            for b in range(n_real):
                id_ = f"{batch['versions'][b]}~{batch['names'][b]}"
                upper_pred[id_] = [unpad(p).tolist()
                                   for p in preds["upper_tokens"][b]]
                upper_tgt[id_] = [unpad(t).tolist()
                                  for t in batch["upper"][b]]
                lower_pred[id_] = [unpad(p).tolist()
                                   for p in preds["lower_tokens"][b]]
                lower_tgt[id_] = [unpad(t).tolist()
                                  for t in batch["lower"][b]]
                key_pred[id_] = preds["key"][b].tolist()
                key_tgt[id_] = np.asarray(batch["key"][b]).tolist()
                ts_pred[id_] = preds["time_sig"][b].tolist()
                ts_tgt[id_] = np.asarray(batch["time_sig"][b]).tolist()

        wer_upper, wer_upper_d = calculate_wer(upper_pred, upper_tgt)
        wer_lower, wer_lower_d = calculate_wer(lower_pred, lower_tgt)
        key_f1, key_f1_d = calculate_f1(key_pred, key_tgt)
        time_f1, time_f1_d = calculate_f1(ts_pred, ts_tgt)
        stage_stats = {
            "loss": float(np.mean(losses)) if losses else -1.0,
            **{k: float(np.mean([c[k] for c in comps_hist]))
               for k in (comps_hist[0] if comps_hist else {})},
            "key_f1": key_f1, "time_f1": time_f1,
            "WER_upper": wer_upper, "WER_lower": wer_lower,
            "WER": (wer_upper + wer_lower) / 2,
        }

        # Per-clip result JSONs (reference: pretrain.py:189-214).
        if not self.is_main_process:
            return stage_stats
        results_dir = os.path.join(self.exp.output_folder, "results", split)
        os.makedirs(results_dir, exist_ok=True)
        for id_ in upper_pred:
            pred = []
            for i in range(len(upper_pred[id_])):
                pred.append([key_pred[id_][i] - 6,
                             time_sig_list[ts_pred[id_][i]],
                             lower_pred[id_][i], upper_pred[id_][i]])
            parts = id_.split("~")
            version = parts[0]
            chunk_name = parts[1] if len(parts) > 1 else id_
            soundfont = parts[2] if len(parts) > 2 else ""
            style = "classical" if chunk_name[:1].islower() else "pop"
            # ASAP features have no version subdirectory, and finetune's
            # valid split IS the test split (reference: finetune.py:261-263;
            # its records point at nonexistent 'asap~'-prefixed targets, a
            # bug fixed here rather than reproduced).
            if version == "asap":
                version_dir, feat_split = "", "test"
            else:
                version_dir, feat_split = str(version), split
            info_path = os.path.join(self.exp.feature_folder, feat_split,
                                     version_dir, "info",
                                     f"{chunk_name}.json")
            composer = "unknown"
            if os.path.exists(info_path):
                with open(info_path) as f:
                    composer = json.load(f).get("composer", "unknown")
            target_path = os.path.join(self.exp.feature_folder, feat_split,
                                       version_dir, "target",
                                       f"{chunk_name}.pkl")
            result = {"style": style, "soundfont": soundfont,
                      "composer": composer, "target_path": target_path,
                      "pred": pred,
                      "wer_upper": wer_upper_d[id_],
                      "wer_lower": wer_lower_d[id_],
                      "key_f1": key_f1_d[id_],
                      "time_f1": time_f1_d[id_]}
            with open(os.path.join(results_dir, f"{id_}.json"), "w") as f:
                json.dump(result, f, indent=2)
        return stage_stats
