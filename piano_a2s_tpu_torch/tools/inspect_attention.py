"""Attention diagnostics: is the decoder aligned, diffuse, or stuck?

Port of scripts/inspect_attention.py. Entropy near ln(n_frames) and an
argmax that does not advance mean the model decodes from its language
model, not the audio; WER and loss alone cannot tell that from "needs more
steps" (docs/DESIGN.md §11). The probe:

    python -m piano_a2s_tpu_torch.tools.inspect_attention \
        --checkpoint <save_dir> --feature-folder <corpus> [--split train] \
        [--config <yaml>] [--clip N] [--bar N] [--staff upper|lower] \
        [--device cuda|cpu] [key=value ...]

Prints, for one clip's bar: per-decode-step attention entropy, argmax
frame, the guided-attention expected center, and teacher-forced token
accuracy. Healthy aligned attention: entropy well below uniform and argmax
tracking the expected centers. From audio (``input_features=audio``) the
log-VQT runs on the device first (the VQT kernel on the card).
"""
from __future__ import annotations

import argparse
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def inspect_attention(trainer, batch, prep=None, bar: int = 0,
                      clip: int = 0, staff: str = "upper",
                      out=print):
    """Run the conv stack and encoder, the bar-level chain conditioned on
    the ground truth up to ``bar``, and a teacher-forced note decode of
    that bar, capturing the attention per step. ``trainer`` is a
    train.harness.Trainer with its weights loaded; ``batch`` a collated
    batch (see DataLoader); ``prep`` the audio frontend
    (train.step.make_audio_frontend) for batches that carry audio. The
    whole batch is decoded, ``clip`` reported. Returns a list of per-step
    dicts (step, entropy, argmax_frame, expected_frame, gt, pred)."""
    import numpy as np
    import torch

    from piano_a2s_tpu_torch.models.score_transcription import (
        ga_within_bar_auto)
    from piano_a2s_tpu_torch.ops import attention as A
    from piano_a2s_tpu_torch.ops import gru as G
    from piano_a2s_tpu_torch.train.step import (batch_to_device,
                                                duration_fraction_table)

    model, cfg, device = trainer.model, trainer.cfg, trainer.device
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            dev = batch_to_device(trainer._device_batch(batch), device)
            if prep is not None:
                dev = prep(dev)
            enc, h0 = model.encode(dev["spectrogram"])
            T_enc = enc.shape[1]
            dec = model.decoder

            def ids(a):
                return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                       device=device)

            # Bar-level GRU chain up to the requested bar (teacher-forced
            # conditioning).
            enc_proj_bar = A.precompute_enc_proj(dec.attn, enc)
            B = enc.shape[0]
            token = dec.sos_token(B, device)
            hidden = h0
            gt_all = np.asarray(batch[staff])          # (B, bars, T)
            for j in range(bar + 1):
                ctx, _ = A.attention_step(dec.attn, enc_proj_bar, enc,
                                          hidden)
                hidden = G.gru_step(dec.gru, torch.cat([token, ctx], -1),
                                    hidden)
                bar_h = hidden
                if j < bar:
                    # Next-bar conditioning from GROUND TRUTH (tf=1).
                    sums = [dec.staff_summaries(
                        ids(batch[s])[None, :, j],
                        torch.as_tensor(np.asarray(batch[f"{s}_lengths"]),
                                        dtype=torch.long)[None, :, j])[0]
                        for s in ("upper", "lower")]
                    token = torch.cat(
                        [sums[0], sums[1],
                         dec.time_sig_emb(ids(batch["time_sig"])[:, j]),
                         dec.key_emb(ids(batch["key"])[:, j])], -1)

            sd = dec.upper_decoder if staff == "upper" else dec.lower_decoder
            enc_proj = A.precompute_enc_proj(sd.attn, enc)
            n_steps = int(batch[f"{staff}_lengths"][clip, bar])
            gt = gt_all[:, bar]

            dur_tab = torch.as_tensor(
                duration_fraction_table(cfg.vocab_size))
            # The auto dispatch matches training: chordal rows (newline
            # event separators) use the event-segmented map, legacy rows
            # the token map.
            within = ga_within_bar_auto(
                torch.as_tensor(gt[clip: clip + 1], dtype=torch.long),
                dur_tab, cfg.pad, cfg.newline)[0].numpy()
            content = dev["ga_content"].cpu().numpy()[clip] \
                if "ga_content" in dev else 1.0
            expected = ((bar + within) / cfg.max_bars * content
                        * T_enc).astype(int)

            h = bar_h
            tok_prev = torch.full((B,), cfg.sos, dtype=torch.long,
                                  device=device)
            rows = []
            correct = 0
            for t in range(n_steps):
                emb = sd.embedding(tok_prev)
                ctx, w = A.attention_step(sd.attn, enc_proj, enc, h)
                h = G.gru_step(sd.gru, torch.cat([emb, ctx], -1), h)
                logits = sd.out(torch.cat([h, ctx], -1))
                pred = int(logits[clip].argmax())
                w0 = w[clip].cpu().numpy()
                rows.append({
                    "step": t,
                    "entropy": float(-(w0 * np.log(w0 + 1e-12)).sum()),
                    "argmax_frame": int(w0.argmax()),
                    "expected_frame": int(expected[t]),
                    "gt": int(gt[clip, t]), "pred": pred,
                })
                correct += pred == int(gt[clip, t])
                tok_prev = ids(gt[:, t])  # teacher forcing
    finally:
        model.train(was_training)
    uniform = float(np.log(T_enc))
    out(f"clip {clip} bar {bar} {staff}: {n_steps} steps, "
        f"tf accuracy {correct}/{n_steps}, uniform entropy {uniform:.2f}")
    out("step entropy argmax expected")
    for r in rows:
        out(f"{r['step']:4d} {r['entropy']:7.2f} {r['argmax_frame']:6d} "
            f"{r['expected_frame']:8d}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True,
                    help="save folder of the port's training commands")
    ap.add_argument("--config", default=os.path.join(REPO, "configs",
                                                     "pretrain.yaml"))
    ap.add_argument("--feature-folder", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--versions", type=int, default=1)
    ap.add_argument("--clip", type=int, default=0)
    ap.add_argument("--bar", type=int, default=0)
    ap.add_argument("--staff", default="upper", choices=["upper", "lower"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu); no fallback")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    import numpy as np

    from piano_a2s_tpu_torch.config import load_experiment
    from piano_a2s_tpu_torch.data.datasets import (DataLoader,
                                                   SyntheticTrainDataset)
    from piano_a2s_tpu_torch.train.harness import Trainer

    overrides = [f"feature_folder={args.feature_folder}",
                 f"save_folder={args.checkpoint}"] + list(args.overrides)
    exp = load_experiment(args.config, overrides)
    trainer = Trainer(exp, device=args.device)
    if not trainer.try_resume():
        raise SystemExit(f"no checkpoint found under {args.checkpoint}")
    ds = SyntheticTrainDataset(
        exp.feature_folder, args.split, versions=range(args.versions),
        rng=np.random.RandomState(exp.seed), **exp.dataset_kwargs())
    batch = next(iter(DataLoader(ds, batch_size=max(args.clip + 1, 2),
                                 shuffle=False, seed=0)))
    batch = trainer._bucketed(batch)
    prep = None
    if trainer.from_audio:
        from piano_a2s_tpu_torch.train.step import make_audio_frontend
        prep = make_audio_frontend(exp.vqt_config(), exp.max_frame_num,
                                   device=trainer.device)
    return inspect_attention(trainer, batch, prep=prep, bar=args.bar,
                             clip=args.clip, staff=args.staff)


if __name__ == "__main__":
    main()
