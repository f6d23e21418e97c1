#!/usr/bin/env python3
"""Where the time of the PyTorch port's greedy decode goes, float32 against
bfloat16 (``decode_dtype``), on one GPU.

    python3 scripts/torch_decode_breakdown.py [--clips 16]

Full width (``ModelConfig()`` defaults), random weights from seed 0,
``--clips`` x 12 s of noise (chip_smoke.py phase e's clips); the VQT and
the encoder run once per dtype, then only ``HierarchicalDecoder.forward``
is timed: the stage that holds ~90% of a served batch (PERF.md section 5).
Random weights seldom emit EOS on every clip, so the staves decode to
their caps.

Prints:
  - the decoder's seconds in turns f32, bf16, bf16, f32 (host clock, each
    call ended by a synchronize), and the decode steps per call;
  - from torch.profiler over one more call of each: the card's busy time,
    the kernel launches, both per decode step, the busy share of the wall,
    and the kernels that take the most time; the ops that take the most
    host time per step (their own time, under the profiler).
Needs a CUDA device; exits non-zero without one.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CLIP_SAMPLES = 192000  # 12 s at 16 kHz


def main(argv=None):
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--clips", type=int, default=16)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_breakdown: CUDA is not available",
              file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from piano_a2s_tpu_torch.models import (ModelConfig, ScoreTranscription,
                                            init_state_dict)
    from piano_a2s_tpu_torch.models import score_transcription as tst
    from piano_a2s_tpu_torch.ops import vqt as tvqt
    from piano_a2s_tpu_torch.utils.device import use_full_float32

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    use_full_float32()
    cfg = ModelConfig()
    model = ScoreTranscription(cfg)
    model.load_state_dict(init_state_dict(cfg, seed=0), strict=True)
    model.to("cuda").eval()
    audio = np.stack([(0.1 * np.random.RandomState(100 + i)
                       .randn(CLIP_SAMPLES)).astype(np.float32)
                      for i in range(args.clips)])
    dtypes = {"f32": None, "bf16": torch.bfloat16}
    steps = [0]
    fast_step = tst._fast_step

    def counted(*a):
        steps[0] += 1
        return fast_step(*a)

    tst._fast_step = counted
    with torch.inference_mode():
        vqt_cfg = tvqt.VQTConfig()
        spec = tvqt.get_vqt(torch.from_numpy(audio).cuda(),
                            tvqt.filters(vqt_cfg, torch.device("cuda")),
                            vqt_cfg)[:, None]
        encoded = {k: model.encode(spec if dt is None else spec.to(dt))
                   for k, dt in dtypes.items()}

        def decode(name):
            enc, hidden = encoded[name]
            steps[0] = 0
            model.decoder(enc, hidden, dtypes[name])

        def timed(name):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            decode(name)
            torch.cuda.synchronize()
            return time.monotonic() - t0

        for name in dtypes:
            decode(name)  # first call at this shape
        turns = {name: [] for name in dtypes}
        for name in ("f32", "bf16", "bf16", "f32"):
            turns[name].append(timed(name))
        n_steps = steps[0]
        print(f"decoder at {args.clips} x 12 s, full width, in turns f32, "
              f"bf16, bf16, f32: "
              + "; ".join(f"{k} {[round(t, 4) for t in v]} s"
                          for k, v in turns.items())
              + f"; {n_steps} decode steps a call")
        for name in dtypes:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = timed(name)
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.device_time_total for e in kernels) / 1e6
            per_step = float(np.median(turns[name])) / steps[0]
            print(f"{name}: profiled call wall {wall:.3f} s (profiler on); "
                  f"card busy {busy:.4f} s in {len(kernels)} kernel "
                  f"launches, busy share {busy / wall:.3f}; per decode "
                  f"step: {1e3 * per_step:.4f} ms unprofiled wall, "
                  f"{1e3 * busy / steps[0]:.4f} ms busy, "
                  f"{len(kernels) / steps[0]:.1f} launches")
            by_name = {}
            for e in kernels:
                n, s = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, s + e.device_time_total / 1e6)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
            for kname, (n, s) in top:
                print(f"  {s:.4f} s in {n} launches: {kname[:100]}")
            ops = sorted((a for a in prof.key_averages()
                          if a.key.startswith("aten::")),
                         key=lambda a: -a.self_cpu_time_total)[:10]
            print(f"  host self time per decode step by op (profiler on): "
                  + ", ".join(f"{a.key} {a.self_cpu_time_total / steps[0]:.1f}"
                              f" us x {a.count / steps[0]:.1f}"
                              for a in ops))
    tst._fast_step = fast_step
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
