#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on one GPU.

    python3 scripts/torch_train_breakdown.py [--clips 4]

Full width (``ModelConfig()`` defaults), random weights from seed 0,
``--clips`` x 12 s of int16 noise with random well-formed targets
(``train/synthetic.py``), trained from audio (the VQT kernel runs inside
the step), tf_ratio 0.7, guided attention on (weight 1, sigma 0.15): the
setting of chip_smoke.py phase g2. What is timed is the step that
``make_train_steps`` returns, and nothing else.

Prints, after two warm-up steps:
  - the seconds of two more steps, each ended by a synchronize;
  - the step's forward (``train_step``'s own ``_forward``) with gradients
    and without (no activation checkpointing), each ended by a
    synchronize: what the checkpoint wrappers cost the forward;
  - from torch.profiler over one more step: for each stage that the step
    and the model mark with ``record_function`` (``train_step/*``,
    ``forward/*``), its wall on the host under the profiler and the kernel
    time on the card that it launched; the card's busy time against the
    step's wall (the device's busy share), the kernel launches, and the
    kernels that take the most time. The backward runs on autograd's own
    thread, so its kernel time is the step's busy time less the other
    stages'. The profiler's bookkeeping takes minutes.
Needs a CUDA device; exits non-zero without one.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CLIP_SAMPLES = 192000  # 12 s at 16 kHz
STEP_STAGES = ("frontend", "forward", "loss", "backward", "update")
MODEL_STAGES = ("convstack", "encoder", "decoder")


def main(argv=None):
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--clips", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_breakdown: CUDA is not available", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from piano_a2s_tpu_torch.models import (ModelConfig, ScoreTranscription,
                                            init_state_dict)
    from piano_a2s_tpu_torch.ops.vqt import VQTConfig
    from piano_a2s_tpu_torch.train import step as tstep
    from piano_a2s_tpu_torch.train.synthetic import audio_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    cfg = ModelConfig()
    model = ScoreTranscription(cfg)
    model.load_state_dict(init_state_dict(cfg, seed=0), strict=True)
    model.to("cuda")
    ga = dict(ga_weight=1.0, ga_sigma=0.15,
              ga_dur_frac=tstep.duration_fraction_table(cfg.vocab_size))
    t_step, _ = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), from_audio=True,
        vqt_cfg=VQTConfig(), max_frame_num=1201, device="cuda", **ga)
    gen = torch.Generator("cuda").manual_seed(0)

    def batch(seed):
        return audio_batch(cfg, args.clips, CLIP_SAMPLES, seed=seed,
                           targets_seed=seed)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        return time.monotonic() - t0

    for i in range(2):
        t_step(model, batch(i), gen, 0.7)
    steps = [timed(lambda i=i: t_step(model, batch(10 + i), gen, 0.7))
             for i in range(2)]
    print(f"train_step at {args.clips} x 12 s, full width: "
          f"{steps[0]:.4f} s, {steps[1]:.4f} s")

    prep = tstep.make_audio_frontend(VQTConfig(), 1201, device="cuda")
    b = prep(tstep.batch_to_device(batch(12), "cuda"))
    model.train()

    def forward():
        tstep._forward(model, b, gen, 0.7, ga["ga_weight"], ga["ga_sigma"],
                       ga["ga_dur_frac"], "auto", None)

    with_grad = timed(forward)
    with torch.no_grad():
        no_grad = timed(forward)
    print(f"train_step's forward with gradients (checkpointed decode) "
          f"{with_grad:.4f} s, without gradients {no_grad:.4f} s")

    b = batch(13)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed(lambda: t_step(model, b, gen, 0.7))
    names = ([f"train_step/{s}" for s in STEP_STAGES]
             + [f"forward/{s}" for s in MODEL_STAGES])
    host, device = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    kernels = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in host:
            host[e.name] += e.cpu_time_total / 1e6
            device[e.name] += e.device_time_total / 1e6
        elif (e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in host):
            kernels.append(e)
    busy = sum(e.device_time_total for e in kernels) / 1e6
    device["train_step/backward"] = busy - sum(
        device[f"train_step/{s}"] for s in STEP_STAGES if s != "backward")
    print(f"profiled train_step (profiler on): wall {wall:.3f} s; card busy "
          f"{busy:.3f} s in {len(kernels)} kernel launches: busy share "
          f"{busy / wall:.3f}; against the mean unprofiled step "
          f"({sum(steps) / len(steps):.3f} s) "
          f"{busy / (sum(steps) / len(steps)):.3f}")
    for name in names:
        print(f"  {name}: host {host[name]:.4f} s (profiler on), card "
              f"{device[name]:.4f} s")
    by_name = {}
    for e in kernels:
        n, s = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, s + e.device_time_total / 1e6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, s) in top:
        print(f"  {s:.4f} s in {n} launches: {name[:90]}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
