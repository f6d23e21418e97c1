#!/usr/bin/env python3
"""Where the VQT kernel's error against float64 comes from, emulated on the
CPU.

    python3 scripts/torch_vqt_error_sources.py FEATURE_FOLDER [--clips 12]

The kernel (csrc/vqt_mag.cu) splits the audio and the filters into TF32
hi and lo parts and sums hi*hi + hi*lo + lo*hi with float32 accumulators.
For the first ``--clips`` WAVs under FEATURE_FOLDER (the synth layout:
{split}/{version}/wav/*.wav, as prepare_data writes it), resampled to
16 kHz as the feature pass does, this prints the largest error after
log_compress, over each clip's own frames, against the float64 product of
the float32 audio and filters, of:
  - the split operands with their products summed exactly (float64): the
    representation error alone, of the audio, of the filters, of both,
    and of both with the lo*lo product the kernel leaves out;
  - the plain float32 version (float32 accumulation, no split).
What is left of the kernel's own error (chip_smoke.py (m2)) is its
accumulation. No GPU is needed.
"""

import argparse
import glob
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from piano_a2s_tpu_torch.ops import vqt as tvqt  # noqa: E402
from piano_a2s_tpu_torch.ops.vqt_cuda import split_tf32  # noqa: E402
from piano_a2s_tpu_torch.utils.audio import read_wav, resample  # noqa: E402


def frames(y, cfg):
    w = cfg.window_size
    padded = torch.nn.functional.pad(y, (w // 2, w // 2))
    return padded.unfold(0, w, cfg.hop_length)[:1 + len(y) // cfg.hop_length]


def magnitude(pairs_cos, pairs_sin):
    re = sum(a @ b for a, b in pairs_cos)
    im = sum(a @ b for a, b in pairs_sin)
    return torch.sqrt(re ** 2 + im ** 2)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("feature_folder")
    parser.add_argument("--clips", type=int, default=12)
    args = parser.parse_args()
    cfg = tvqt.VQTConfig()
    cos32, sin32 = (torch.tensor(np.asarray(k, np.float32))
                    for k in tvqt.build_kernels(cfg))
    c, s = cos32.double(), sin32.double()
    (ch, cl), (sh, sl) = ([p.double() for p in split_tf32(k)]
                          for k in (cos32, sin32))
    wavs = sorted(glob.glob(os.path.join(args.feature_folder, "*", "*",
                                         "wav", "*.wav")))[:args.clips]
    if not wavs:
        parser.error(f"no WAVs under {args.feature_folder}/*/*/wav/")
    worst = {}
    for wav in wavs:
        data, sr = read_wav(wav)
        y = torch.tensor(resample(data, sr, cfg.sample_rate))
        f = frames(y.double(), cfg)
        fh, fl = (frames(p.double(), cfg) for p in split_tf32(y))
        f32 = frames(y, cfg)
        ref = tvqt.log_compress(magnitude([(f, c)], [(f, s)]))
        cases = {
            "split audio": magnitude([(fh, c), (fl, c)], [(fh, s), (fl, s)]),
            "split filters": magnitude([(f, ch), (f, cl)],
                                       [(f, sh), (f, sl)]),
            "split both (the kernel's 3 products)": magnitude(
                [(fh, ch), (fh, cl), (fl, ch)],
                [(fh, sh), (fh, sl), (fl, sh)]),
            "split both, 4 products": magnitude(
                [(fh, ch), (fh, cl), (fl, ch), (fl, cl)],
                [(fh, sh), (fh, sl), (fl, sh), (fl, sl)]),
            "plain float32": magnitude([(f32, cos32)],
                                       [(f32, sin32)]).double(),
        }
        for name, mag in cases.items():
            err = float((tvqt.log_compress(mag) - ref).abs().max())
            worst[name] = max(worst.get(name, 0.0), err)
    print(f"{len(wavs)} clips of {args.feature_folder}: largest error after "
          f"log_compress against float64")
    for name, err in worst.items():
        print(f"  {name}: {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
