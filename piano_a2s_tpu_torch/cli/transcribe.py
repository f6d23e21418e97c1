"""Transcribe piano audio to score files (Kern / MusicXML / MIDI) with the
PyTorch port.

Usage:
    python -m piano_a2s_tpu_torch.cli.transcribe input.wav [more.wav ...] \
        [--checkpoint CKPT] [--out-dir DIR] [--device cuda|cpu] [--bf16]

Each input becomes {out-dir}/{stem}.krn/.xml/.mid. Clips longer than 12 s
are truncated (the model's capability envelope).
"""

import argparse
import os
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("inputs", nargs="+",
                        help="WAV files, or .npy mono float/int16 arrays at "
                             "the model sample rate")
    parser.add_argument("--checkpoint", default=None,
                        help="torch checkpoint file (.ckpt/.pt/.pth), "
                             "a save folder of the port's training "
                             "commands (its best checkpoint by WER) or "
                             "one CKPT+... directory of it ("
                             "default: random weights — smoke mode)")
    parser.add_argument("--out-dir", default=".")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 conv stack and decode loop (the "
                             "softmaxes and log-probs stay float32)")
    parser.add_argument("--batch-size", type=int, default=16,
                        help="batch size for many-file jobs (>4 inputs "
                             "stream through transcribe_stream)")
    parser.add_argument("--config", default=None,
                        help="experiment YAML for model dims (default: "
                             "the full-size production model)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, cuda:N or cpu)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from piano_a2s_tpu_torch.infer import load_transcriber, result_to_files
    from piano_a2s_tpu_torch.utils.audio import (read_wav, read_wav_pcm16,
                                                 resample)

    decode_dtype = torch.bfloat16 if args.bf16 else None
    if args.config:
        from piano_a2s_tpu_torch.config import load_configs
        cfg, vqt_cfg, max_frame_num = load_configs(args.config)
        tr = load_transcriber(args.checkpoint, cfg=cfg, vqt_cfg=vqt_cfg,
                              max_frame_num=max_frame_num,
                              device=args.device, decode_dtype=decode_dtype)
    else:
        tr = load_transcriber(args.checkpoint, device=args.device,
                              decode_dtype=decode_dtype)
    os.makedirs(args.out_dir, exist_ok=True)

    def clip_gen():
        for path in args.inputs:
            if path.endswith(".npy"):
                audio = np.asarray(np.load(path))
                if audio.ndim != 1 or not (
                        np.issubdtype(audio.dtype, np.floating)
                        or audio.dtype == np.int16):
                    sys.exit(f"{path}: expected a 1-D float or int16 PCM "
                             f"audio array at {tr.vqt_cfg.sample_rate} Hz, "
                             f"got {audio.dtype}{audio.shape} (is this a "
                             "spectrogram or stereo file?)")
                # int16 passes through raw (converted on the device with
                # read_wav's /32768 scale); floats normalise to float32.
                yield (audio if audio.dtype == np.int16
                       else audio.astype(np.float32))
                continue
            pcm = read_wav_pcm16(path, expect_sr=tr.vqt_cfg.sample_rate)
            if pcm is not None:
                yield pcm[0]
                continue
            audio, sr = read_wav(path)
            yield resample(audio, sr, tr.vqt_cfg.sample_rate)

    t0 = time.time()
    if len(args.inputs) <= 4:
        results = iter(tr.transcribe_batch(list(clip_gen())))
    else:
        # Cap the batch at the next power of two >= #inputs so e.g. 5 files
        # pad to 8 decoded clips, not to the full default batch of 16.
        pow2 = 1 << (len(args.inputs) - 1).bit_length()
        results = tr.transcribe_stream(clip_gen(),
                                       batch_size=min(args.batch_size, pow2),
                                       depth=3)
    used = set()
    n = 0
    for path, target in zip(args.inputs, results):
        stem = os.path.splitext(os.path.basename(path))[0]
        unique, k = stem, 1
        while unique in used:  # same basename from different directories
            unique = f"{stem}.{k}"
            k += 1
        used.add(unique)
        paths = result_to_files(target, os.path.join(args.out_dir, unique))
        n += 1
        print(f"{path} -> {', '.join(sorted(paths.values()))}")
    dt = time.time() - t0
    print(f"transcribed {n} clip(s) in {dt:.2f}s ({n / dt:.2f} clips/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
