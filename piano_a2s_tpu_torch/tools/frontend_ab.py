"""Frontend A/B: decoding from stored spectrograms against decoding from
audio through the device VQT.

Port of scripts/frontend_ab.py. For every clip in a corpus split that has
raw audio beside its spectrogram ({split}/{v}/audio/{name}.npy; the synth
corpus writes these), decode twice with the same checkpoint:

  A) from the stored spectrogram (the offline feature pass's frontend),
     through Transcriber._infer_spectrogram;
  B) from raw audio through the device VQT (the VQT kernel on the card,
     one clip a call), i.e. the serving path, Transcriber._infer_audio;

and report per-bar time-signature/key agreement, raw token agreement, and
WER against the target for both frontends.

Usage:
  python -m piano_a2s_tpu_torch.tools.frontend_ab <save_folder_or_ckpt> \
      <feature_folder> [--split test] [--version 0] \
      [--config configs/pretrain.yaml] [--out report.json] \
      [--device cuda|cpu]
"""

import argparse
import json
import os
import pickle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint",
                    help="a save folder of the port's training commands "
                         "(its best checkpoint by WER), one CKPT+... "
                         "directory of it, or a torch checkpoint file")
    ap.add_argument("feature_folder")
    ap.add_argument("--split", default="test")
    ap.add_argument("--version", default="0")
    ap.add_argument("--config", default=None,
                    help="experiment YAML for model dims (default: the "
                         "full-size production config)")
    ap.add_argument("--out", default=None, help="write report JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu); no fallback")
    args = ap.parse_args(argv)

    import numpy as np

    from piano_a2s_tpu_torch.infer import load_transcriber
    from piano_a2s_tpu_torch.models import ModelConfig
    from piano_a2s_tpu_torch.train.metrics import calculate_wer, unpad

    if args.config:
        from piano_a2s_tpu_torch.config import load_experiment
        exp = load_experiment(args.config)
        tr = load_transcriber(args.checkpoint, cfg=exp.model_config(),
                              vqt_cfg=exp.vqt_config(),
                              max_frame_num=exp.max_frame_num,
                              device=args.device)
    else:
        tr = load_transcriber(args.checkpoint, cfg=ModelConfig(),
                              device=args.device)

    base = os.path.join(args.feature_folder, args.split, args.version)
    audio_dir = os.path.join(base, "audio")
    if not os.path.isdir(audio_dir):
        raise SystemExit(f"{audio_dir} not found — the corpus must carry "
                         f"raw audio for an A/B (synth corpora do)")
    names = sorted(f[:-4] for f in os.listdir(audio_dir)
                   if f.endswith(".npy"))

    stats = {"clips": 0, "bars": 0, "ts_agree": 0, "key_agree": 0,
             "upper_tok_agree": 0, "upper_tok_total": 0,
             "lower_tok_agree": 0, "lower_tok_total": 0}
    pred_a_u, pred_b_u, tgt_u = {}, {}, {}
    pred_a_l, pred_b_l, tgt_l = {}, {}, {}

    for name in names:
        spec = np.load(os.path.join(base, "spectrogram", f"{name}.npy"))
        audio = np.load(os.path.join(audio_dir, f"{name}.npy"))
        padded = np.zeros((1, 1, tr.max_frame_num, spec.shape[-1]),
                          np.float32)
        padded[0, 0, :spec.shape[0]] = spec[:tr.max_frame_num]
        a = tr._to_host(tr._infer_spectrogram(padded))
        b = tr._to_host(tr._infer_audio(tr._prep_audio(audio)[None]))

        with open(os.path.join(base, "target",
                               f"{name.split('~')[0]}.pkl"), "rb") as f:
            target = pickle.load(f)
        ts_a, key_a, up_a, low_a = a[0][0], a[1][0], a[2][0], a[3][0]
        ts_b, key_b, up_b, low_b = b[0][0], b[1][0], b[2][0], b[3][0]
        stats["clips"] += 1
        for m in range(min(len(target), len(ts_a))):
            stats["bars"] += 1
            stats["ts_agree"] += int(ts_a[m] == ts_b[m])
            stats["key_agree"] += int(key_a[m] == key_b[m])
            for staff, xa, xb in (("upper", up_a[m], up_b[m]),
                                  ("lower", low_a[m], low_b[m])):
                ta, tb = unpad(xa), unpad(xb)
                n = max(len(ta), len(tb))
                agree = sum(int(x == y) for x, y in zip(ta, tb))
                stats[f"{staff}_tok_agree"] += agree
                stats[f"{staff}_tok_total"] += n
        pred_a_u[name] = [unpad(x).tolist() for x in up_a]
        pred_b_u[name] = [unpad(x).tolist() for x in up_b]
        tgt_u[name] = [m[3] for m in target]
        pred_a_l[name] = [unpad(x).tolist() for x in low_a]
        pred_b_l[name] = [unpad(x).tolist() for x in low_b]
        tgt_l[name] = [m[2] for m in target]

    report = {
        "clips": stats["clips"],
        "ts_agreement": stats["ts_agree"] / max(stats["bars"], 1),
        "key_agreement": stats["key_agree"] / max(stats["bars"], 1),
        "upper_token_agreement":
            stats["upper_tok_agree"] / max(stats["upper_tok_total"], 1),
        "lower_token_agreement":
            stats["lower_tok_agree"] / max(stats["lower_tok_total"], 1),
        "upper_tokens_compared": stats["upper_tok_total"],
        "lower_tokens_compared": stats["lower_tok_total"],
        "wer_vs_target": {
            "oracle_spectrogram_upper": calculate_wer(pred_a_u, tgt_u)[0],
            "oracle_spectrogram_lower": calculate_wer(pred_a_l, tgt_l)[0],
            "ondevice_vqt_upper": calculate_wer(pred_b_u, tgt_u)[0],
            "ondevice_vqt_lower": calculate_wer(pred_b_l, tgt_l)[0],
        },
    }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
