#!/usr/bin/env python3
"""Smoke run of the PyTorch port (piano_a2s_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  (a) device: require CUDA; print the card's name and power limit.
  (b) build: compile the VQT kernel from piano_a2s_tpu_torch/csrc/ with
      nvcc into build/piano_a2s_tpu_torch/; print ptxas registers, spills.
  (c) kernel vs plain: the VQT kernel and its plain PyTorch version (f32)
      on the card, at every shape the main paths give it: 2 x 3 s and
      16 x 12 s of noise (serving), 4 x 12 s and 2 x 12 s of int16 noise
      scaled by 1/32768 (a training batch and microbatch of (g2)), 1 x
      12 s of it (one clip: (n1)'s side B, Transcriber.spectrogram, (o4)'s
      microbatch), 8 x 12 s (with 1, 2, 4 and 16, every batch (n3)'s
      server pads to) and 64 x 12 s ((o1)'s batch), each
      held against the plain version run in float64: the kernel's max
      error must be at most twice the plain f32 version's, on the
      magnitude and after log_compress (taken in float64), and
      |kernel - plain| < 1e-4 on the magnitude. Then both times at
      16 x 12 s, in turns plain, kernel, kernel, plain.
  (d) full-width model on one 12 s clip, GPU against the port's CPU path
      (random weights from seed 0): spectrogram within 1e-4, encoder
      output within 1e-3, decode log-probs within 1e-3 up to the first
      token divergence, which may only fall where the CPU's top-2
      log-prob margin is below 1e-3.
  (e) batch serving: Transcriber.transcribe_batch on 16 clips of 12 s.
  (f) HTTP server: three WAV requests (one asking for Kern) through the
      port's make_server.
  (g) training on the card. (g1) at a small width in float64, dropout
      patched out and tf_ratio 1.0: one train_step on the card against the
      port's CPU path; the loss components, the gradient norm, every
      updated parameter and every BN running statistic within 1e-9.
      (g2) at full width (random weights from seed 0): 4 x 12 s int16
      noise clips with random well-formed targets, the log-VQT frontend
      (the VQT kernel) inside the step, tf_ratio 0.7, guided attention on
      (weight 1, sigma 0.15), a CUDA generator; 3 train_steps, then one
      train_step_accum with accum_steps=2. Every loss finite, the
      parameters and BN statistics changed, one kernel launch per
      (micro)batch; prints seconds per step and peak device memory.
  (h) the training harness through its commands, at full width from
      audio: a corpus of int16 noise clips of 10-12 s with 5-bar targets
      (10-120 upper and 5-60 lower tokens a staff) written to a temporary
      folder (train/0: 8 clips, valid/0 and test/0: 4 each, and an ASAP
      copy with 4 train and 4 test clips); cli.pretrain (one epoch, batch
      4, --profile) then cli.finetune (one epoch, warm-started from it),
      then load_transcriber on finetune's save folder, which must hold the
      checkpoint's weights bit for bit, and 2 clips transcribed; then
      finetune's checkpoint restored into a Trainer on the CPU and one
      saved there restored into a Trainer on the card, model and Adadelta
      state bit for bit. Checks the losses are finite, one committed
      checkpoint per save folder, a result JSON per valid and test clip,
      the bucketed caps below (398, 189) and finetune's fresh Adadelta;
      prints the caps, seconds per train step, eval-stage and checkpoint
      seconds, checkpoint bytes, peak device memory and the train logs.
  (i) the bfloat16 paths at full width. (i1) serving: a Transcriber with
      decode_dtype=torch.bfloat16 on (d)'s clip against float32 on the
      card, float32 log-probs within 0.05 up to the first token
      divergence, which may only fall where float32's top-2 margin is
      below 0.05; stage seconds; (e)'s 16 clips in turns f32, bf16, bf16,
      f32 (clips/s of each); then one bf16 transcribe_batch, checked
      well-formed, and one request through make_server. (i2) training:
      (g2)'s setting (its first two batches, guided attention, tf 0.7)
      with conv_dtype=torch.bfloat16, 2 train_steps: losses finite,
      parameters and BN statistics moved and still float32, Adadelta state
      float32, and peak device memory below (g2)'s float32 peak; prints
      seconds per step and both peaks.
  (j) the multi-device paths at full width. (j1) serving:
      Transcriber(use_mesh=True) on every visible card must give (e)'s 16
      clips (e)'s results exactly; with devices=["cuda:0", "cuda:0"] (two
      shards, each on its own CUDA stream and host thread) each 8-clip
      shard must equal that shard through the plain Transcriber; clips/s
      of the plain, every-card and two-shard Transcribers in turns. (j2)
      data-parallel training in (g2)'s setting, one step with
      accum_steps=2 on (g2)'s first batch (row weights 1, as the Trainer
      gives them; the plain step run twice shows the card's own spread):
      at world size 1 over NCCL in
      this process the loss, parameters and BN buffers must equal the
      plain train_step_accum within 1e-6 relative, and the data-parallel
      eval step's predictions the plain eval step's; then two ranks as
      subprocesses on cuda:0 over gloo (NCCL refuses two ranks on one
      card), global batch 4, each within 1e-5 of world size 1 and the two
      identical; where there are two cards, the same over NCCL on cuda:0
      and cuda:1. Prints seconds per step and peak memory per rank.
  (k) the synth path at full width. (k1) a learnable corpus written at run
      time with the port's data/synth.py: write_corpus (2 songs, direct
      host VQT, float32 audio) and 4 songs of make_song with 2-4 upper and
      1-3 lower notes a bar; host seconds a song. (k2) each clip's stored
      audio through get_vqt on the card (the VQT kernel) against its stored
      host spectrogram over the clip's own frames, within 1e-4 (the plain
      f32 version's error printed beside it). (k3) the model of seed 0
      trained on the 4 short clips from audio (the kernel in every step),
      Adadelta at lr 1.0, tf 1.0, until its greedy decode emits EOS in every
      bar of both staves and matches the targets above 0.8 (checked every
      10 steps; fails at a cap of 180 steps); prints the steps, seconds,
      first and last loss and the match. (k4) a Transcriber of the
      memorized weights on the clips tiled to 16, in turns with the
      random-weight Transcriber of (e): clips/s and decode steps a bar.
      (k)'s memorized clips are the corpus's test split, which (l) reads.
  (l) the offline evaluation path at full width, with (k3)'s weights (no
      second model is trained). (l1) a Trainer on the card (configs/
      pretrain.yaml, input_features=audio, batch 4) runs its test stage,
      Trainer.evaluate, over (k)'s 4 clips from audio: one result JSON per
      clip; prints the stage seconds, WER and F1. (l2) a copy of the
      records with each prediction replaced by the clip's target through
      the port's evaluate command in this process (cli.evaluate.main,
      native MV2H and MUSTER): every clip must score MV2H 1.0 on all six
      keys with no export error, and MUSTER 11 zeros. (l3) the same
      command on (l1)'s records: prints the export errors, each clip's
      and the mean MV2H components, the 4-way mean, the 11 MUSTER rates
      and the host seconds a clip of the export, MV2H and MUSTER; the
      summary must count every clip with an MV2H JSON, with at most 1
      export error and a mean MV2H of at least 0.5.
  (m) the score-to-corpus path at full width. (m1) the four real-score
      excerpts of tests/fixtures/kern (the first two renamed into the test
      and valid split lists) through the port's prepare_data command in
      this process: preprocess, split, midi (the native EPR engine), clean,
      render and spectrograms over 4 versions (cli.pretrain with midi_syn
      epr reads versions 0-3 of valid and test), with a stand-in for
      FluidSynth first on PATH (additive synthesis in a Python script, a
      timbre seeded from each soundfont's name; no synthesizer or soundfont
      is installed). Checks the native kern library is the port's own build
      and equal to its Python twins on every excerpt (both staves, tiefix,
      every transposition of FEASIBLE_TRANSPOSES[0]); each chunk routed to
      its split; clean_files removed exactly what breaks its rules; every
      MIDI with its target, one WAV (three for test), a spectrogram and an
      int16 audio file; every target 5 bars of (key, time signature,
      lower, upper). Prints the files per split and version and the host
      seconds of each stage. (m2) every clip through get_vqt on the card
      against its stored host spectrogram over its own frames, on the
      float32 samples the feature pass used: within 1e-4 or, failing that,
      at most twice the plain f32 version's error (the kernel's contract of
      (c)); and on the stored int16 audio, which training reads: at most
      1e-4 beyond the plain f32 version's error. (m3) cli.pretrain
      (configs/pretrain.yaml, input_features=audio, batch 4, one epoch,
      --profile) on the corpus with its valid and test stages: losses
      finite, one result JSON per valid and test clip; prints seconds per
      train step, the bucketed caps and peak device memory.
  (n) the diagnostic tools at full width, run after (l) on (k)'s corpus
      with (k3)'s weights, saved once through the port's Checkpointer into
      a save folder that each tool loads as a user would. (n1)
      tools.frontend_ab.main over (k)'s 4 test clips: side A from the
      stored host spectrograms (Transcriber._infer_spectrogram), side B
      from audio (the VQT kernel at 1 x 12 s, once a clip); time and key
      signature agreement 1.0, token agreement at least 0.95 a staff, the
      two sides' WERs within 0.02; prints the report. (n2)
      tools.inspect_attention.main from audio for clip 0, bar 0, the upper
      then the lower staff (configs/pretrain.yaml, input_features=audio):
      one kernel launch a call, one row a target token, teacher-forced
      accuracy at least 0.8; prints the mean attention entropy against
      ln(1201) and the share of steps whose argmax frame lies within 60
      frames of the guided-attention expected frame. (n3)
      tools.load_test.main, 16 clients and 64 requests over (k)'s 4 test
      clips, against the port's server in this process (a Transcriber of
      the save folder, warmed at every padded batch size as the server
      command warms it, dynamic batches of at most 16): 64 answered, no
      error, one kernel launch a dynamic batch (the server's /stats
      batches); prints clips/s and /stats, and how many of the distinct
      clips' HTTP results differ from Transcriber.transcribe of the clip
      alone (a reading: the decode's stop is coupled across a batch).
  (o) the port's last gaps at full width. (o1) the decode's stop groups
      (decode_chunk, the Transcriber's default "auto"), with (k3)'s
      weights on 64 clips in runs of 16: (k)'s clips tiled, half and
      half, noise, quieter noise. transcribe_batch of the 64 in f32 (4
      groups of 16) and bf16 (2 groups of 32); each group against its
      clips decoded alone: the steps each clip ran at every bar and staff
      equal (the gate; its control, the one-group decode of the 64, must
      fail it in some group), log-probs within 1e-3 (bf16: a reading) up
      to a first token divergence, which may only fall at a top-2 margin
      below 1e-3 (bf16: twice the group's largest log-prob difference),
      and a group without one equal outright; the steps each group ran by
      bar and staff, at least two f32 groups apart; clips/s of "auto" and
      None in turns and the clips that differ between them. (o2) (k3)'s
      weights in a save folder through cli.export_checkpoint,
      cli.import_checkpoint and load_transcriber, bare and --modulelist:
      the weights bit-equal, the tokens of (k)'s clips equal. (o3) entry() on the card: output
      shapes, seconds, tokens equal to Transcriber._infer_spectrogram's;
      the two-rank dry run (``entry multichip 2``) on the card.
      (o4) the data-parallel step at B=4, A=4 on two gloo ranks on cuda:0
      (one row a microbatch: rank 0 owns none and computes stand-in rows
      that weigh 0 and count in no statistic; row 0 weighs 0, so
      microbatch 0 takes the BatchNorm's unweighted fallback), full width
      from audio, targets of at most 64 tokens: each rank within 1e-5 of
      the plain step, the ranks identical.

Each main path has its own launch counts, zeroed just before it and read
just after it: serving over (e) and (f), training over (g2), the harness
over (h), which must launch the kernel exactly once per train batch, eval
batch and transcribe call, bf16 serving over (i1)'s batch and request,
bf16 training over (i2), once per step, mesh serving over one call of each
mesh Transcriber of (j1), once per shard, and data-parallel training over
(j2)'s world-size-1 step and eval and the ranks' steps (which print their
counts), once per rank per microbatch, the synth path over (k3) and
(k4)'s first batch, once per train step, greedy decode and batch, the
evaluation path over (l1)'s test stage, once per eval batch, the
diagnostic paths over (n1)'s clips, once a clip, (n2)'s two calls, once a
call, and (n3)'s load test, once a dynamic batch, the prepare path over
(m3)'s epoch, once per train and eval batch, and serving with stop groups
over (o1)'s two batches, once a batch; (o4)'s ranks add their launches,
once per rank per microbatch, to data-parallel training's. Each path
must have launched every kernel it runs. The line before the last
holds the kernels' JSON record (``launches`` is the sum over the paths,
``launches_by_path`` each path's count); the last line is the result
object.

``python3 chip_smoke.py --train-dp-rank RANK WORLD INIT BACKEND DEVICE OUT
ACCUM BATCH`` is one rank of (j2) or (o4), started by the phase itself.
The run prints its total seconds before the kernels' record.
"""

import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
import wave

import numpy as np

TOL_MAG = 1e-4  # |kernel - plain| on the magnitude
# The kernel's error against float64 may be at most this multiple of the
# plain f32 version's. A bound on |kernel - plain| after the log would only
# say whether two f32 sums were added in the same order.
F64_RATIO = 2.0
TOL_SPEC, TOL_ENC, TOL_LOGP, TOL_MARGIN = 1e-4, 1e-3, 1e-3, 1e-3
N_CLIPS, CLIP_SAMPLES = 16, 192000
TOL_TRAIN_F64 = 1e-9  # (g1) card against CPU, float64
TRAIN_CLIPS, TRAIN_STEPS = 4, 3
# (i): the bf16 paths. Log-probs of the bf16 decode against float32 on the
# card (tests/test_bf16_decode.py's bound), up to a divergence at a top-2
# margin below TOL_MARGIN_BF16; train steps of (i2).
TOL_LOGP_BF16, TOL_MARGIN_BF16, BF16_TRAIN_STEPS = 0.05, 0.05, 2
# (h): clips per split (the ASAP copy for finetune: its valid split is its
# test split), batch, clips transcribed; 10-12 s of audio a clip, staves of
# 10-120 upper and 5-60 lower tokens a bar, the length scale of real bars.
H_CLIPS = {"train": 8, "valid": 4, "test": 4}
H_ASAP = {"train": 4, "test": 4}
H_BATCH, H_TRANSCRIBE = 4, 2
H_SAMPLES, H_UPPER, H_LOWER = (160000, 192000), (10, 120), (5, 60)
# (j): shards and ranks on one card; (j2) world size 1 against the plain
# step (relative), the ranks against world size 1 (relative: gloo and NCCL
# sum the gradients in another order than one rank), a rank's time limit.
J_SHARDS, TOL_DP_WORLD1, TOL_DP_RANKS, DP_TIMEOUT_S = 2, 1e-6, 1e-5, 600
DP_RANK_SCRIPT = os.path.abspath(__file__)  # (j2)'s ranks run this file
# (k): songs of write_corpus held against the kernel in (k2); the clips
# (k3) memorizes, with fewer notes a bar than the corpus's (4-9 upper, 3-6
# lower) so that the teacher-forced decode is short; its tf ratio, greedy
# decode every K_EVAL_EVERY steps, the match it must pass and its step cap
# (twice the 90 steps it took on an H100).
K_SEED, K_CORPUS_SONGS, K_CLIPS = 11, 2, 4
K_UPPER_NOTES, K_LOWER_NOTES = (2, 4), (1, 3)
K_TF, K_EVAL_EVERY, K_MATCH, K_MAX_STEPS = 1.0, 10, 0.8, 180
# (l): the test stage's batch (all of (k)'s memorized clips in one), and
# what the memorized model's evaluation must reach: export errors, mean
# MV2H (the identity copy must score 1.0).
L_BATCH, L_MAX_ERRORS, L_MIN_MV2H = 4, 1, 0.5
# (n): the diagnostic tools on (k)'s corpus and (k3)'s weights. (n1) the
# least token agreement of the two frontends on each staff and the largest
# gap of their WERs; (n2) the least teacher-forced accuracy (the JAX
# package's overfit measure, as (k3)) and the window around the expected
# frame an argmax counts as aligned in (5% of 1201 frames); (n3) the load
# test's clients and requests, the server's largest batch.
N_MIN_TOKEN_AGREEMENT, N_MAX_WER_GAP = 0.95, 0.02
N_MIN_TF_ACCURACY, N_ALIGN_FRAMES = 0.8, 60
N_CLIENTS, N_REQUESTS, N_MAX_BATCH = 16, 64, 16
# (m): the real-score excerpts (the first two renamed into the test and the
# valid split), the versions prepared and (m3)'s batch. cli.pretrain with
# midi_syn=epr reads versions 0-3 of valid and test, and xml_to_midi renders
# only the versions it is given: the corpus needs 4.
M_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "fixtures", "kern")
M_VERSIONS, M_BATCH = 4, 4
# (m1): a stand-in for FluidSynth, written into (m)'s temporary folder and
# put first on PATH (no synthesizer or soundfont is installed there).
FLUIDSYNTH_STANDIN = '''#!{python}
"""A stand-in for `fluidsynth -ni <sf2> <mid> -F <wav> -r <rate>`: each
note of the MIDI (read with the port's symbolic/midi_io.py) rendered by
additive synthesis, with a timbre seeded from the soundfont's file name,
written as a 16-bit mono WAV at <rate> (at most 12 s)."""
import os, sys, wave, zlib
sys.path.insert(0, {repo!r})
import numpy as np
from piano_a2s_tpu_torch.symbolic.midi_io import read_midi

args = sys.argv[1:]
assert len(args) == 7 and args[0] == "-ni" and args[3] == "-F" \\
    and args[5] == "-r", args
font, midi, wav, rate = args[1], args[2], args[4], int(args[6])
assert font.endswith(".sf2"), font
assert open(midi, "rb").read(4) == b"MThd", midi
rng = np.random.RandomState(zlib.crc32(os.path.basename(font).encode()))
k = np.arange(1, 9)
amps = rng.uniform(0.3, 1.0, len(k)) / k ** rng.uniform(0.7, 1.5)
decay = rng.uniform(0.4, 1.5)  # seconds, at middle C
notes = read_midi(midi).notes()
end = max((off for _, off, _, _ in notes), default=0.0)
out = np.zeros(int(min(end + 0.25, 12.0) * rate))
for on, off, pitch, vel in notes:
    start = int(on * rate)
    n = min(int((off - on + 0.05) * rate), len(out) - start)
    if n <= 0:
        continue
    t = np.arange(n) / rate
    f0 = 440.0 * 2 ** ((pitch - 69) / 12)
    use = k * f0 < rate / 2
    tone = (amps[use, None] * np.sin(2 * np.pi * f0 * k[use, None] * t)
            ).sum(0)
    env = np.minimum(1.0, t / 0.005) * np.exp(
        -t / (decay * np.sqrt(261.63 / f0)))
    env *= np.minimum(1.0, (n - np.arange(n)) / (0.05 * rate))
    out[start:start + n] += vel / 127.0 * tone * env
peak = np.abs(out).max()
with wave.open(wav, "wb") as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(rate)
    w.writeframes((0.8 * 32767 * out / max(peak, 1e-9)).astype("<i2")
                  .tobytes())
'''
# (o): the stop groups' batch (4 groups of 16 in f32, 2 of 32 in bf16);
# (o4)'s microbatches (B = TRAIN_CLIPS at A = O_ACCUM: one row each, so on
# two ranks one rank owns none) and its target width, which bounds the
# teacher-forced decode's steps.
O_CLIPS, O_ACCUM, O_WIDTH = 64, 4, 64
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data sheet: HBM 3.35 TB/s; dense TF32 tensor cores 494.7 TFLOP/s.
HBM_BYTES_PER_S, TF32_FLOP_PER_S = 3.35e12, 494.7e12


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps=20):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def noise(shape, amp, seed):
    return (amp * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def errors_f64(tvqt, mag, ref64):
    """Max |mag - ref64| on the magnitude and after log_compress, both in
    float64."""
    m = mag.double()
    return {"mag": (m - ref64).abs().max().item(),
            "log": (tvqt.log_compress(m) - tvqt.log_compress(ref64)).abs()
            .max().item()}


def phase_kernel_vs_plain(torch, tvqt, launches_of):
    from piano_a2s_tpu_torch.train.synthetic import pcm16_noise
    from piano_a2s_tpu_torch.utils.audio import PCM16_SCALE
    cfg = tvqt.VQTConfig()
    dev = torch.device("cuda")
    kernels = tvqt.filters(cfg, dev)
    kernels64 = tvqt.filters(cfg, dev, torch.float64)

    def pcm(shape, seed):
        return pcm16_noise(shape, seed).astype(np.float32) / PCM16_SCALE

    # Serving shapes, then (g2)'s batch and microbatch, then one full clip
    # (frontend_ab's side B, Transcriber.spectrogram, (o4)'s microbatch),
    # then every other power of two the server pads a dynamic batch of at
    # most N_MAX_BATCH to ((n3)), then (o1)'s batch of O_CLIPS; 16 x 12 s
    # last, as it is timed below.
    rows = [TRAIN_CLIPS, TRAIN_CLIPS // 2, 1]
    rows += [1 << i for i in range(N_MAX_BATCH.bit_length())
             if 1 << i not in rows + [N_CLIPS]] + [O_CLIPS]
    cases = (((2, 48000), noise((2, 48000), 0.2, 0)),
             *(((b, CLIP_SAMPLES), pcm((b, CLIP_SAMPLES), 5 + i))
               for i, b in enumerate(rows)),
             ((N_CLIPS, CLIP_SAMPLES), noise((N_CLIPS, CLIP_SAMPLES), 0.1, 1)))
    check(N_CLIPS == N_MAX_BATCH, "(c) the timed case is (n3)'s largest batch")
    worst = 0.0
    for shape, audio in cases:
        y = torch.tensor(audio, device=dev)
        before = launches_of()
        got = tvqt.vqt_magnitude(y, kernels, cfg)
        ref = tvqt.vqt_magnitude_torch(y, kernels, cfg)
        ref64 = tvqt.vqt_magnitude_torch(y.double(), kernels64, cfg)
        torch.cuda.synchronize()
        check(launches_of() == before + 1, "vqt kernel launched once")
        check(got.shape == ref.shape == (shape[0], 1 + shape[1] // 160, 480),
              f"vqt shape {tuple(got.shape)}")
        check(torch.isfinite(got).all().item(), "vqt kernel output finite")
        err = (got - ref).abs().max().item()
        err_f64 = errors_f64(tvqt, got, ref64)
        plain_err_f64 = errors_f64(tvqt, ref, ref64)
        print(f"(c) vqt {shape}: max|kernel-plain| {err:.3e} (atol "
              f"{TOL_MAG}); against float64, kernel {err_f64['mag']:.3e} "
              f"and plain f32 {plain_err_f64['mag']:.3e} on the magnitude, "
              f"kernel {err_f64['log']:.3e} and plain f32 "
              f"{plain_err_f64['log']:.3e} after log_compress (kernel at "
              f"most {F64_RATIO} x plain)")
        check(err < TOL_MAG, "kernel matches plain")
        for measure in ("mag", "log"):
            check(err_f64[measure] <= F64_RATIO * plain_err_f64[measure],
                  f"kernel as accurate as plain f32 ({measure})")
        worst = max(worst, err)
    # Turns: plain, kernel, kernel, plain.
    t_plain = [cuda_ms(lambda: tvqt.vqt_magnitude_torch(y, kernels, cfg))]
    t_kern = [cuda_ms(lambda: tvqt.vqt_magnitude(y, kernels, cfg))
              for _ in range(2)]
    t_plain.append(cuda_ms(lambda: tvqt.vqt_magnitude_torch(y, kernels,
                                                            cfg)))
    ms, plain_ms = float(np.median(t_kern)), float(np.median(t_plain))
    gflop = 2 * 2 * N_CLIPS * (1 + CLIP_SAMPLES // 160) * 1120 * 480 / 1e9
    print(f"(c) vqt ({N_CLIPS}, {CLIP_SAMPLES}): kernel {t_kern} ms, plain "
          f"{t_plain} ms (median of 20 each); {gflop:.1f} GFLOP -> kernel "
          f"{gflop / ms:.1f} TFLOP/s, plain {gflop / plain_ms:.1f} TFLOP/s; "
          f"the kernel's three TF32 products are {3 * gflop:.1f} GFLOP of "
          f"tensor-core work -> {3 * gflop / ms:.1f} TFLOP/s")
    return worst, err_f64, plain_err_f64, ms, plain_ms


def vqt_bound(batch, samples, window=1120, bins=480, hop=160):
    """(ms, what bounds it): the least time of the VQT magnitude at (batch,
    samples) on the card. Bytes: audio read once, both filters read once,
    the magnitude written once. Operations: the kernel's three TF32
    products (hi*hi, hi*lo, lo*hi) of the 2 x frames x window x bins
    multiply-adds of the cos and sin filters."""
    frames = 1 + samples // hop
    nbytes = 4 * (batch * samples + 2 * window * bins + batch * frames * bins)
    flop = 3 * 2 * 2 * batch * frames * window * bins
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / TF32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                       else "bytes")


def decode_one(torch, tvqt, tr, audio):
    """One clip through ``tr``'s frontend and model stage by stage, in its
    decode dtype; every output on the CPU."""
    dt = tr.decode_dtype
    with torch.inference_mode():
        x = torch.from_numpy(audio).to(tr.device)
        spec = tvqt.get_vqt(x, tr.kernels, tr.vqt_cfg)
        enc, hidden = tr.model.encode(
            spec[:, None] if dt is None else spec[:, None].to(dt))
        ts, key, up, low, aux = tr.model.decoder(enc, hidden, dt)
    return {k: v.cpu() for k, v in (
        ("spec", spec), ("enc", enc), ("ts", ts), ("key", key),
        ("up", up), ("low", low), ("up_tok", aux["upper_tokens"]),
        ("low_tok", aux["lower_tokens"]),
        ("up_len", aux["upper_lengths"]),
        ("low_len", aux["lower_lengths"]))}


def decode_diff(ref, got, cfg, row=0):
    """How ``got``'s greedy decode of clip ``row`` differs from ``ref``'s:
    the time and key signature log-probs and each staff's log-probs up to
    the first token divergence (within the steps ``ref``'s staff ran); the
    bars after it are conditioned on other tokens and are not compared.
    Returns (steps compared, max |difference|, first divergence (bar,
    staff, step) or None, the largest of ``ref``'s top-2 log-prob margins
    at the divergences: one a staff, in the bar of the first)."""
    steps, worst, diverged, margin = 0, 0.0, None, None
    for bar in range(cfg.max_bars):
        if diverged is not None:
            break
        for key_name in ("ts", "key"):
            e = (got[key_name][row, bar]
                 - ref[key_name][row, bar]).abs().max()
            worst = max(worst, e.item())
        for staff in ("up", "low"):
            gt = got[f"{staff}_tok"][row, bar]
            rt = ref[f"{staff}_tok"][row, bar]
            ran = int((ref[staff][row, bar].abs().sum(-1) > 0).sum())
            diff = (gt[:ran] != rt[:ran]).nonzero()
            first = int(diff[0]) if len(diff) else None
            stop = ran if first is None else first + 1
            e = (got[staff][row, bar, :stop].float()
                 - ref[staff][row, bar, :stop].float()).abs()
            worst = max(worst, e.max().item())
            steps += stop
            if first is not None:
                top2 = ref[staff][row, bar, first].topk(2).values
                gap = (top2[0] - top2[1]).item()
                margin = gap if margin is None else max(margin, gap)
                diverged = diverged or (bar, staff, first)
    return steps, worst, diverged, margin


def compare_decodes(ref, got, cfg, tol_logp, tol_margin, label):
    """Hold ``got``'s greedy decode of one clip against ``ref``'s
    (``decode_diff``): log-probs within ``tol_logp`` up to the first token
    divergence, which may only fall where ``ref``'s top-2 log-prob margin
    is below ``tol_margin``. Returns (steps compared, max |difference|,
    first divergence)."""
    steps, worst, diverged, margin = decode_diff(ref, got, cfg)
    if diverged is not None:
        bar, staff, first = diverged
        print(f"{label} tokens diverge at bar {bar} staff {staff} "
              f"step {first}: top-2 margin {margin:.3e}")
        check(margin < tol_margin, f"{label} divergence only at a near-tie")
    print(f"{label} decode: {steps} steps compared, max|difference| log-prob "
          f"{worst:.3e} (atol {tol_logp}); first divergence: {diverged}")
    check(steps > 0, f"{label} decode steps compared")
    check(worst < tol_logp, f"{label} decode log-probs agree")
    return steps, worst, diverged


def phase_gpu_vs_cpu(torch, cfg, tvqt, gpu, cpu):
    audio = noise((1, CLIP_SAMPLES), 0.1, 2)
    outs = {}
    for name, tr in (("gpu", gpu), ("cpu", cpu)):
        t0 = time.monotonic()
        outs[name] = decode_one(torch, tvqt, tr, audio)
        print(f"(d) {name}: one clip through the full-width model in "
              f"{time.monotonic() - t0:.2f} s")
    g, c = outs["gpu"], outs["cpu"]
    for k in g:
        if g[k].is_floating_point():
            check(torch.isfinite(g[k]).all().item(), f"{k} finite")
    check(g["spec"].shape == (1, 1 + CLIP_SAMPLES // 160, 480),
          "spectrogram shape")
    check(g["enc"].shape == (1, 1201, 2 * cfg.hidden_size), "encoder shape")
    err_spec = (g["spec"] - c["spec"]).abs().max().item()
    err_enc = (g["enc"] - c["enc"]).abs().max().item()
    print(f"(d) spectrogram max|gpu-cpu| {err_spec:.3e} (atol {TOL_SPEC}); "
          f"encoder {err_enc:.3e} (atol {TOL_ENC})")
    check(err_spec < TOL_SPEC, "spectrogram agrees")
    check(err_enc < TOL_ENC, "encoder output agrees")
    compare_decodes(c, g, cfg, TOL_LOGP, TOL_MARGIN, "(d)")


def stage_seconds(torch, tvqt, tr, clips):
    """Host-clock seconds of each stage of one batch in the transcriber's
    decode dtype, each ended by a synchronize (the decode loop syncs every
    step anyway)."""
    dt = tr.decode_dtype
    out = {}
    with torch.inference_mode():
        t = time.monotonic()
        x = torch.from_numpy(np.stack(clips)).to(tr.device)
        torch.cuda.synchronize()
        out["upload"], t = time.monotonic() - t, time.monotonic()
        spec = tvqt.get_vqt(x, tr.kernels, tr.vqt_cfg)[:, None]
        torch.cuda.synchronize()
        out["vqt"], t = time.monotonic() - t, time.monotonic()
        feats = tr.model.convstack(spec if dt is None else spec.to(dt))
        torch.cuda.synchronize()
        out["convstack"], t = time.monotonic() - t, time.monotonic()
        enc, hidden = tr.model.encoder(feats.to(torch.float32))
        torch.cuda.synchronize()
        out["encoder"], t = time.monotonic() - t, time.monotonic()
        tr.model.decoder(enc, hidden, dt)
        torch.cuda.synchronize()
        out["decoder"] = time.monotonic() - t
    return out


def wav_bytes(audio, sr):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2")
                      .tobytes())
    return buf.getvalue()


def phase_server(make_server, gpu, label="(f)", n_requests=3):
    """``n_requests`` WAV requests from as many client threads through
    make_server on the transcriber ``gpu``; the third asks for Kern."""
    httpd = make_server(gpu, "127.0.0.1", 0, max_batch=4, max_wait_ms=50)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    replies = [None] * n_requests

    def client(i):
        query = "?format=kern" if i == 2 else ""
        body = wav_bytes(noise((4 * 16000,), 0.1, 10 + i), 16000)
        req = urllib.request.Request(f"{url}/transcribe{query}", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            replies[i] = (r.status, r.read())

    try:
        t0 = time.monotonic()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(n_requests)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        dt = time.monotonic() - t0
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.load(r)
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            stats = json.load(r)
    finally:
        httpd.shutdown()
        httpd.service.close()
        thread.join(timeout=30)
    for i, reply in enumerate(replies):
        check(reply is not None, f"request {i} answered")
        status, body = reply
        print(f"{label} request {i}{' (kern)' if i == 2 else ''}: HTTP "
              f"{status}, {len(body)} bytes")
        check(status == 200 and len(body) > 0, f"request {i} status/body")
    if n_requests > 2:
        check(replies[2][1].decode().startswith("!! upper staff"),
              "kern body")
    check(len(json.loads(replies[0][1])["bars"]) == 5, "json bars")
    print(f"{label} {n_requests} request(s) answered in {dt:.2f} s; device "
          f"{health['device']!r}; batches {stats['batches']}, clips "
          f"{stats['clips']}")
    check(not thread.is_alive(), "server thread stopped")


def check_results(results, cfg, label, n_clips=N_CLIPS):
    """The target structures of a batch of ``n_clips`` clips are
    well-formed."""
    check(len(results) == n_clips, f"{label} one result per clip")
    for bars in results:
        check(len(bars) == cfg.max_bars, f"{label} bars per clip")
        for key, ts, lower, upper in bars:
            check(-6 <= key <= 7 and "/" in ts,
                  f"{label} key and time signature")
            check(len(upper) <= cfg.max_length[0]
                  and len(lower) <= cfg.max_length[1],
                  f"{label} staff lengths")


def phase_serve_bf16(torch, tvqt, Transcriber, make_server, state_dict, cfg,
                     clips, f32_seconds, kernel):
    """(i1) bf16 serving at full width: (d)'s clip decoded in bf16 against
    float32 on the card; stage seconds; transcribe_batch of (e)'s clips in
    turns f32, bf16, bf16, f32; then the path, with the kernel's launch
    count zeroed first: one bf16 transcribe_batch and one request through
    make_server. Returns the path's launches."""
    f32 = Transcriber(state_dict, cfg, device="cuda")
    bf16 = Transcriber(state_dict, cfg, device="cuda",
                       decode_dtype=torch.bfloat16)
    audio = noise((1, CLIP_SAMPLES), 0.1, 2)
    ref = decode_one(torch, tvqt, f32, audio)
    got = decode_one(torch, tvqt, bf16, audio)
    for k, v in got.items():
        if v.is_floating_point():
            check(torch.isfinite(v).all().item(), f"(i1) {k} finite")
    check(all(got[k].dtype == torch.float32 for k in ("ts", "key", "up",
                                                      "low")),
          "(i1) bf16 decode log-probs are float32")
    compare_decodes(ref, got, cfg, TOL_LOGP_BF16, TOL_MARGIN_BF16, "(i1)")

    bf16.transcribe_batch(clips)  # first call at this shape
    stages = stage_seconds(torch, tvqt, bf16, clips)
    print(f"(i1) bf16 stage seconds at batch {N_CLIPS}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    turns = {"f32": [], "bf16": []}
    for name, tr in (("f32", f32), ("bf16", bf16), ("bf16", bf16),
                     ("f32", f32)):
        t0 = time.monotonic()
        tr.transcribe_batch(clips)
        turns[name].append(time.monotonic() - t0)
    rate = {k: N_CLIPS / float(np.median(v)) for k, v in turns.items()}
    print(f"(i1) transcribe_batch of {N_CLIPS} x 12 s clips in turns f32, "
          f"bf16, bf16, f32: f32 {[round(t, 3) for t in turns['f32']]} s, "
          f"bf16 {[round(t, 3) for t in turns['bf16']]} s; clips/s f32 "
          f"{rate['f32']:.2f}, bf16 {rate['bf16']:.2f} (bf16 / f32 "
          f"{rate['bf16'] / rate['f32']:.3f}); (e)'s f32 "
          f"{N_CLIPS / f32_seconds:.2f}")
    del f32

    kernel.launches = 0
    t0 = time.monotonic()
    results = bf16.transcribe_batch(clips)
    dt = time.monotonic() - t0
    check_results(results, cfg, "(i1)")
    after_batch = kernel.launches
    print(f"(i1) bf16 transcribe_batch of {N_CLIPS} x 12 s clips: {dt:.3f} s,"
          f" {N_CLIPS / dt:.2f} clips/s; vqt kernel launches {after_batch}")
    check(after_batch > 0, "the bf16 batch went through the vqt kernel")
    phase_server(make_server, bf16, "(i1)", n_requests=1)
    check(kernel.launches > after_batch,
          "the bf16 server went through the vqt kernel")
    return kernel.launches


def phase_train_f64(torch, tmodels, tstep, tlayers):
    """(g1) One float64 train_step on the card against the CPU path."""
    from piano_a2s_tpu_torch.train.synthetic import random_targets
    cfg = tmodels.ModelConfig(
        freq_bins=24, conv_feature_size=32, hidden_size=24, max_bars=2,
        max_length=(10, 7), note_emb_size=8, staff_emb_size=8)
    state_dict = tmodels.init_state_dict(cfg, seed=1, dtype=torch.float64)
    batch = dict(random_targets(cfg, 2, seed=3), spectrogram=np.random
                 .RandomState(4).randn(2, 1, 30, cfg.freq_bins))
    dropout = tlayers.dropout
    tlayers.dropout = lambda x, rate, train, generator=None: x
    results = {}
    try:
        for dev in ("cuda", "cpu"):
            model = tmodels.ScoreTranscription(cfg).double()
            model.load_state_dict(state_dict, strict=True)
            model.to(dev)
            t_step, _ = tstep.make_train_steps(
                tstep.make_optimizer(model.parameters()), device=dev)
            out = t_step(model, batch, torch.Generator(dev).manual_seed(0),
                         1.0)
            results[dev] = (out, {k: v.cpu()
                                  for k, v in model.state_dict().items()})
    finally:
        tlayers.dropout = dropout
    (g_out, g_sd), (c_out, c_sd) = results["cuda"], results["cpu"]
    errs = {k: abs(float(g_out.components[k]) - float(c_out.components[k]))
            for k in c_out.components}
    errs["grad_norm"] = abs(float(g_out.grad_norm) - float(c_out.grad_norm))
    err_sd = max((g_sd[k].double() - c_sd[k].double()).abs().max().item()
                 for k in c_sd)
    moved = max((c_sd[k].double() - state_dict[k].double()).abs().max()
                .item() for k in c_sd)
    print(f"(g1) float64 train_step, card vs CPU: loss {float(c_out.loss):.6f}"
          f"; max|diff| components and grad norm {max(errs.values()):.3e}, "
          f"parameters and BN statistics {err_sd:.3e} (atol "
          f"{TOL_TRAIN_F64}); the step moved them by up to {moved:.3e}")
    check(all(np.isfinite(float(v)) for v in c_out.components.values()),
          "(g1) finite loss")
    check(max(errs.values()) < TOL_TRAIN_F64, "(g1) loss and norm agree")
    check(err_sd < TOL_TRAIN_F64, "(g1) parameters and BN statistics agree")
    check(moved > 1e-6, "(g1) the step changed the model")


def full_width_training(tmodels, tstep, tvqt, device="cuda"):
    """(g2)'s, (i2)'s and (j2)'s set-up: the full-width model from seed 0
    on the card, a snapshot of its state, its optimizer and the options of
    a train step from audio with guided attention."""
    cfg = tmodels.ModelConfig()
    model = tmodels.ScoreTranscription(cfg)
    model.load_state_dict(tmodels.init_state_dict(cfg, seed=0), strict=True)
    model.to(device)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = tstep.make_optimizer(model.parameters())
    opts = dict(from_audio=True, vqt_cfg=tvqt.VQTConfig(),
                max_frame_num=1201, ga_weight=1.0, ga_sigma=0.15,
                ga_dur_frac=tstep.duration_fraction_table(cfg.vocab_size),
                device=device)
    return cfg, model, before, optimizer, opts


def train_batch(cfg, i):
    """The i-th training batch of (g2) and (i2): 4 x 12 s of int16 noise
    with random targets."""
    from piano_a2s_tpu_torch.train.synthetic import audio_batch
    return audio_batch(cfg, TRAIN_CLIPS, CLIP_SAMPLES, seed=200 + i,
                       targets_seed=300 + i)


def uneven_batch(cfg):
    """(o4)'s global batch: TRAIN_CLIPS x 12 s of int16 noise, random
    targets of at most O_WIDTH tokens a staff (the teacher-forced decode
    runs to their width), row weights as the Trainer gives a padded last
    batch: row 0 weighs 0, so microbatch 0's BatchNorm statistics take the
    unweighted fallback, in which a stand-in row must count for nothing."""
    import dataclasses

    from piano_a2s_tpu_torch.train.synthetic import (pcm16_noise,
                                                     random_targets)
    narrow = dataclasses.replace(cfg, max_length=(O_WIDTH, O_WIDTH))
    return dict(random_targets(narrow, TRAIN_CLIPS, 310),
                audio=pcm16_noise((TRAIN_CLIPS, CLIP_SAMPLES), 210),
                sample_weight=(np.arange(TRAIN_CLIPS) > 0).astype(np.float32))


def dp_batch(cfg, i):
    """(j2)'s i-th batch: (g2)'s with the row weights the Trainer gives
    every batch (all 1 here), so that one rank's BatchNorm takes the same
    weighted sums as the data-parallel one."""
    return dict(train_batch(cfg, i),
                sample_weight=np.ones(TRAIN_CLIPS, np.float32))


def phase_train_full(torch, tmodels, tstep, tvqt, launches_of):
    """(g2) Full-width training from audio on the card."""
    cfg, model, before, optimizer, opts = full_width_training(
        tmodels, tstep, tvqt)
    t_step, _ = tstep.make_train_steps(optimizer, **opts)
    t_accum, _ = tstep.make_train_steps(optimizer, accum_steps=2, **opts)
    gen = torch.Generator("cuda").manual_seed(0)
    print(f"(g2) device memory allocated before the steps: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for i in range(TRAIN_STEPS + 1):
        batch = train_batch(cfg, i)
        accum = i == TRAIN_STEPS
        launched = launches_of()
        t0 = time.monotonic()
        out = (t_accum if accum else t_step)(model, batch, gen, 0.7)
        torch.cuda.synchronize()
        seconds.append(time.monotonic() - t0)
        comps = {k: float(v) for k, v in out.components.items()}
        losses.append(float(out.loss))
        print(f"(g2) {'train_step_accum (2 x 2 clips)' if accum else 'train_step'}"
              f" {i}: {seconds[-1]:.3f} s, loss {losses[-1]:.4f} "
              + ", ".join(f"{k} {v:.4f}" for k, v in comps.items())
              + f", grad norm {float(out.grad_norm):.3f}")
        check(all(np.isfinite(v) for v in comps.values())
              and np.isfinite(losses[-1]), "(g2) finite losses")
        check("ga_loss" in comps, "(g2) guided attention on")
        check(launches_of() == launched + (2 if accum else 1),
              "(g2) one vqt kernel launch per (micro)batch")
    peak = torch.cuda.max_memory_allocated()
    after = model.state_dict()
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    n_params = sum(1 for _ in model.named_parameters())
    bn = [k for k in before if "running_" in k]
    print(f"(g2) {TRAIN_STEPS} train_steps and 1 train_step_accum at "
          f"{TRAIN_CLIPS} x 12 s, full width: seconds per step "
          f"{[round(s, 3) for s in seconds]}; peak device memory "
          f"{peak / 2**30:.2f} GiB; {len(changed)} of {len(before)} state "
          f"tensors changed")
    check(all(k in changed for k in bn), "(g2) BN running statistics moved")
    check(sum(1 for k, _ in model.named_parameters() if k in changed)
          == n_params, "(g2) every parameter moved")
    return seconds, peak


def phase_train_bf16(torch, tmodels, tstep, tvqt, launches_of, f32_peak):
    """(i2) (g2)'s setting with the ConvStack in bf16 (conv_dtype): 2
    train_steps on (g2)'s first two batches. Returns (seconds, peak)."""
    cfg, model, before, optimizer, opts = full_width_training(
        tmodels, tstep, tvqt)
    t_step, _ = tstep.make_train_steps(optimizer, conv_dtype=torch.bfloat16,
                                       **opts)
    gen = torch.Generator("cuda").manual_seed(0)
    print(f"(i2) device memory allocated before the steps: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    for i in range(BF16_TRAIN_STEPS):
        launched = launches_of()
        t0 = time.monotonic()
        out = t_step(model, train_batch(cfg, i), gen, 0.7)
        torch.cuda.synchronize()
        seconds.append(time.monotonic() - t0)
        comps = {k: float(v) for k, v in out.components.items()}
        print(f"(i2) bf16 train_step {i}: {seconds[-1]:.3f} s, loss "
              f"{float(out.loss):.4f} "
              + ", ".join(f"{k} {v:.4f}" for k, v in comps.items())
              + f", grad norm {float(out.grad_norm):.3f}")
        check(all(np.isfinite(v) for v in comps.values())
              and np.isfinite(float(out.loss)), "(i2) finite losses")
        check(launches_of() == launched + 1,
              "(i2) one vqt kernel launch per batch")
    peak = torch.cuda.max_memory_allocated()
    after = model.state_dict()
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    print(f"(i2) {BF16_TRAIN_STEPS} bf16 train_steps at {TRAIN_CLIPS} x 12 s,"
          f" full width: seconds per step {[round(s, 3) for s in seconds]}; "
          f"peak device memory {peak / 2**30:.2f} GiB, (g2)'s float32 "
          f"{f32_peak / 2**30:.2f} GiB; {len(changed)} of {len(before)} "
          f"state tensors changed")
    check(all(k in changed for k in before if "running_" in k),
          "(i2) BN running statistics moved")
    check(all(k in changed for k, _ in model.named_parameters()),
          "(i2) every parameter moved")
    check(all(v.dtype == before[k].dtype for k, v in after.items()),
          "(i2) parameters and BN statistics kept their float32")
    check(all(s[k].dtype == torch.float32 for s in optimizer.state.values()
              for k in ("square_avg", "acc_delta")),
          "(i2) Adadelta state float32")
    check(peak < f32_peak, "(i2) bf16 peak below (g2)'s float32 peak")
    return seconds, peak


def phase_serve_mesh(torch, Transcriber, state_dict, cfg, clips, e_results,
                     kernel):
    """(j1) Multi-device serving: the mesh on every visible card against
    (e), two shards on cuda:0 against the plain Transcriber shard by
    shard, clips/s in turns, with the two shards also run in host threads
    (a CUDA stream each), the design the mesh's loop replaced; then the
    path, with the kernel's launch count zeroed first: one call of each
    mesh Transcriber. Returns the path's launches."""
    plain = Transcriber(state_dict, cfg, device="cuda")
    every = Transcriber(state_dict, cfg, use_mesh=True)
    pair = Transcriber(state_dict, cfg, use_mesh=True,
                       devices=["cuda:0"] * J_SHARDS)
    check(every.transcribe_batch(clips) == e_results,
          "(j1) the mesh on every card gives (e)'s results")
    half = N_CLIPS // J_SHARDS
    alone = []
    for i in range(J_SHARDS):
        alone += plain.transcribe_batch(clips[i * half:(i + 1) * half])
    check(pair.transcribe_batch(clips) == alone,
          f"(j1) each of {J_SHARDS} shards on cuda:0 equals it through the "
          "plain Transcriber")
    streams = [torch.cuda.Stream() for _ in range(J_SHARDS)]

    def threaded():
        """The pair's shards at once, each in a host thread and stream."""
        parts = np.split(pair.prepare_batch(clips)[0], J_SHARDS)
        out = [None] * J_SHARDS

        def run(i):
            with torch.cuda.stream(streams[i]):
                out[i] = pair._to_host(pair._infer_audio(parts[i], i))

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(J_SHARDS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        check(all(o is not None for o in out), "(j1) threaded shards ran")

    calls = {"plain": lambda: plain.transcribe_batch(clips),
             "every": lambda: every.transcribe_batch(clips),
             "pair": lambda: pair.transcribe_batch(clips),
             "threads": threaded}
    turns = {k: [] for k in calls}
    for name in ("plain", "every", "pair", "threads", "threads", "pair",
                 "every", "plain"):
        t0 = time.monotonic()
        calls[name]()
        turns[name].append(time.monotonic() - t0)
    rate = {k: N_CLIPS / float(np.median(v)) for k, v in turns.items()}
    print(f"(j1) {N_CLIPS} x 12 s clips in turns: plain Transcriber, mesh on "
          f"every card ({len(every.devices)}), {J_SHARDS} shards on cuda:0 "
          f"(the mesh's loop), the {J_SHARDS} shards in host threads, and "
          f"back: " + ", ".join(
              f"{k} {[round(t, 3) for t in v]} s ({rate[k]:.2f} clips/s)"
              for k, v in turns.items())
          + f"; {J_SHARDS} shards / plain {rate['pair'] / rate['plain']:.3f}"
          f", threads / {J_SHARDS} shards "
          f"{rate['threads'] / rate['pair']:.3f}")
    del plain
    kernel.launches = 0
    check_results(every.transcribe_batch(clips), cfg, "(j1) every card")
    check_results(pair.transcribe_batch(clips), cfg, "(j1) two shards")
    expected = len(every.devices) + J_SHARDS
    print(f"(j1) vqt kernel launches over one call of each mesh: "
          f"{kernel.launches} (expected {expected}, one per shard)")
    check(kernel.launches == expected, "(j1) one vqt launch per shard")
    return kernel.launches


def state_diff(torch, got, ref, before):
    """How far state dict ``got`` is from ``ref`` (both after one step from
    ``before``), over every floating tensor, in float64 on the CPU: "rel"
    is |got - ref| / |ref| (L2 over all tensors), "update" |got - ref| /
    |ref - before| (the share of the step's change that differs), "max"
    the largest element difference, "equal" the bit-equal tensors."""
    d2 = r2 = u2 = worst = 0.0
    equal = 0
    for k, r in ref.items():
        g, r = got[k].cpu(), r.cpu()
        equal += int(torch.equal(g, r))
        if r.is_floating_point():
            diff = g.double() - r.double()
            d2 += float((diff ** 2).sum())
            r2 += float((r.double() ** 2).sum())
            u2 += float(((r.double() - before[k].cpu().double()) ** 2).sum())
            worst = max(worst, float(diff.abs().max()))
    return {"rel": (d2 / r2) ** 0.5, "update": (d2 / max(u2, 1e-300)) ** 0.5,
            "max": worst, "equal": f"{equal}/{len(ref)}"}


def fmt_diff(d):
    return (f"{d['rel']:.3e} relative, {d['update']:.3e} of the update, "
            f"max |difference| {d['max']:.3e}, {d['equal']} tensors "
            f"bit-equal")


def train_dp_rank(argv):
    """One rank of (j2) or (o4): join the group, one data-parallel step
    with ACCUM microbatches on the global batch BATCH ("j2": (g2)'s first;
    "o4": ``uneven_batch``), save the loss and the model state to
    OUT/rank<RANK>.pt and print a result line with the seconds, the peak
    memory and the kernel's launches."""
    import torch

    import piano_a2s_tpu_torch.models as tmodels
    import piano_a2s_tpu_torch.train.step as tstep
    from piano_a2s_tpu_torch import parallel
    from piano_a2s_tpu_torch.ops import vqt as tvqt
    from piano_a2s_tpu_torch.ops.vqt_cuda import vqt_magnitude_cuda

    rank, world, init, backend, device, out, accum, which = argv
    rank, world, accum = int(rank), int(world), int(accum)
    dev = parallel.distributed_init(init_method=f"file://{init}", rank=rank,
                                    world_size=world, device=device,
                                    backend=backend, timeout_s=DP_TIMEOUT_S)
    cfg, model, _, optimizer, opts = full_width_training(
        tmodels, tstep, tvqt, dev)
    t_dp, _ = tstep.make_train_steps(optimizer, accum_steps=accum,
                                     group=torch.distributed.group.WORLD,
                                     **opts)
    batch = dp_batch(cfg, 0) if which == "j2" else uneven_batch(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    vqt_magnitude_cuda.launches = 0
    t0 = time.monotonic()
    res = t_dp(model, batch, torch.Generator(dev).manual_seed(0), 0.7)
    torch.cuda.synchronize(dev)
    seconds = time.monotonic() - t0
    torch.save({"loss": float(res.loss),
                "state": {k: v.cpu() for k, v in model.state_dict().items()}},
               os.path.join(out, f"rank{rank}.pt"))
    print("DP_RANK_RESULT " + json.dumps({
        "rank": rank, "device": str(dev), "seconds": seconds,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "launches": vqt_magnitude_cuda.launches, "loss": float(res.loss)}),
        flush=True)
    parallel.shutdown()
    return 0


def run_dp_ranks(torch, backend, devices, ref_state, ref_loss, before,
                 accum=2, which="j2"):
    """(j2) or (o4) (``which``): ``len(devices)`` ranks of train_dp_rank as
    subprocesses over ``backend``, ``accum`` microbatches a step; each
    must exit 0, launch the kernel once a microbatch, equal ``ref_*``
    (world size 1) within TOL_DP_RANKS and equal the others. Returns the
    ranks' result lines."""
    label = f"({which})"
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        world = len(devices)
        procs = [subprocess.Popen(
            [sys.executable, DP_RANK_SCRIPT, "--train-dp-rank",
             str(r), str(world), init, backend, devices[r], tmp, str(accum),
             which],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                print(text[-4000:])
            check(p.returncode == 0, f"{label} {backend} rank {r} exit code")
        results = [json.loads(line.split(" ", 1)[1]) for text in outs
                   for line in text.splitlines()
                   if line.startswith("DP_RANK_RESULT ")]
        check(len(results) == world, f"{label} {backend}: a result per rank")
        saved = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=True) for r in range(world)]
    for r, (res, sv) in enumerate(zip(results, saved)):
        d = state_diff(torch, sv["state"], ref_state, before)
        loss_err = abs(sv["loss"] - ref_loss) / abs(ref_loss)
        print(f"{label} {backend} rank {r} on {res['device']}: "
              f"{res['seconds']:.3f} s a step, peak {res['peak_gib']:.2f} "
              f"GiB, vqt launches {res['launches']}; loss {sv['loss']:.6f}; "
              f"against world size 1: loss {loss_err:.3e} relative, "
              f"parameters and BN buffers {fmt_diff(d)} (tolerance "
              f"{TOL_DP_RANKS} relative)")
        check(loss_err < TOL_DP_RANKS and d["rel"] < TOL_DP_RANKS,
              f"{label} {backend} rank {r} equals world size 1")
        check(res["launches"] == accum, f"{label} {backend} rank {r}: one "
              "vqt launch per microbatch")
    for r in range(1, world):
        check(saved[r]["loss"] == saved[0]["loss"] and all(
            torch.equal(saved[r]["state"][k], v)
            for k, v in saved[0]["state"].items()),
            f"{label} {backend} ranks 0 and {r} identical")
    return results


def phase_train_dp(torch, tmodels, tstep, tvqt, kernel):
    """(j2) Data-parallel training at full width: the plain step twice
    (the card's own spread: atomics in the backward sum in another order
    each run) and once without row weights, then world size 1 over NCCL
    (eval, the step, the step without row weights), then the ranks.
    Returns the path's launches: world size 1's and the ranks'."""
    import tempfile

    import torch.distributed as dist

    from piano_a2s_tpu_torch import parallel

    cfg, model, before, _, opts = full_width_training(tmodels, tstep, tvqt)
    batch, eval_batch = dp_batch(cfg, 0), dp_batch(cfg, 1)
    unweighted = train_batch(cfg, 0)  # the same rows without sample weights

    def fresh_steps(group=None):
        model.load_state_dict(before)
        return tstep.make_train_steps(tstep.make_optimizer(
            model.parameters()), accum_steps=2, group=group, **opts)

    def timed_step(t_step, batch=batch):
        t0 = time.monotonic()
        out = t_step(model, batch, torch.Generator("cuda").manual_seed(0),
                     0.7)
        torch.cuda.synchronize()
        return out, time.monotonic() - t0, {
            k: v.detach().clone() for k, v in model.state_dict().items()}

    plain = []
    for _ in range(2):
        t_plain, e_plain = fresh_steps()
        plain.append(timed_step(t_plain))
    ref_u, _, ref_u_state = timed_step(fresh_steps()[0], unweighted)
    model.load_state_dict(before)
    _, ref_preds = e_plain(model, eval_batch)  # seed 0's weights, as e_dp's
    (ref, plain_s, ref_state), (again, again_s, again_state) = plain
    ref_loss = float(ref.loss)
    spread = state_diff(torch, again_state, ref_state, before)
    print(f"(j2) the plain train_step_accum twice: {plain_s:.3f} and "
          f"{again_s:.3f} s; losses {ref_loss:.6f} and "
          f"{float(again.loss):.6f}; the second against the first: "
          f"{fmt_diff(spread)}")

    with tempfile.TemporaryDirectory() as tmp:
        parallel.distributed_init(init_method=f"file://{tmp}/init", rank=0,
                                  world_size=1, device="cuda:0")
        try:
            t_dp, e_dp = fresh_steps(dist.group.WORLD)
            torch.cuda.reset_peak_memory_stats()
            kernel.launches = 0
            _, preds = e_dp(model, eval_batch)
            got, dp_s, dp_state = timed_step(t_dp)
            peak = torch.cuda.max_memory_allocated()
            got_u, _, dp_u_state = timed_step(
                fresh_steps(dist.group.WORLD)[0], unweighted)
            launches = kernel.launches
        finally:
            parallel.shutdown()
    d = state_diff(torch, dp_state, ref_state, before)
    loss_err = abs(float(got.loss) - ref_loss) / abs(ref_loss)
    print(f"(j2) world size 1 (NCCL) against the first plain step: "
          f"{dp_s:.3f} s a step, peak {peak / 2**30:.2f} GiB; loss "
          f"{float(got.loss):.6f} ({loss_err:.3e} relative); parameters and "
          f"BN buffers {fmt_diff(d)} (tolerance {TOL_DP_WORLD1} relative); "
          f"vqt launches {launches}")
    check(loss_err < TOL_DP_WORLD1 and d["rel"] < TOL_DP_WORLD1,
          "(j2) world size 1 equals the plain step")
    # Without row weights one rank's BatchNorm takes torch's mean and var,
    # the data-parallel one the same sums as with weights of 1.
    d_u = state_diff(torch, dp_u_state, ref_u_state, before)
    loss_err_u = abs(float(got_u.loss) - float(ref_u.loss)) / abs(
        float(ref_u.loss))
    print(f"(j2) without row weights, world size 1 against the plain step: "
          f"loss {float(got_u.loss):.6f} ({loss_err_u:.3e} relative); "
          f"parameters and BN buffers {fmt_diff(d_u)} (tolerance "
          f"{TOL_DP_WORLD1} relative)")
    check(loss_err_u < TOL_DP_WORLD1 and d_u["rel"] < TOL_DP_WORLD1,
          "(j2) world size 1 equals the plain step without row weights")
    check(all(torch.equal(preds[k], v) for k, v in ref_preds.items()),
          "(j2) the data-parallel eval step's predictions equal the plain")
    check(launches == 5, "(j2) one vqt launch per microbatch and eval batch")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    runs = [("gloo", ["cuda:0"] * 2)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", ["cuda:0", "cuda:1"]))
    for backend, devices in runs:
        t0 = time.monotonic()
        results = run_dp_ranks(torch, backend, devices, dp_state,
                               float(got.loss), before)
        launches += sum(r["launches"] for r in results)
        print(f"(j2) {len(devices)} ranks over {backend} on {devices}: "
              f"{time.monotonic() - t0:.1f} s with start-up")
    return launches


class Spy:
    """Wraps methods of a class (or functions of a module) so that each
    call records its phase, its seconds and what ``probe(obj, args, kwargs,
    result)`` reads (``obj`` is a function's first argument); they
    themselves run unchanged. ``undo`` restores them."""

    def __init__(self):
        self.calls = {}
        self.phase = None
        self._undo = []

    def wrap(self, cls, name, probe=None):
        orig = getattr(cls, name)
        calls = self.calls.setdefault(f"{cls.__name__}.{name}", [])

        def wrapper(obj, *args, **kwargs):
            t0 = time.monotonic()
            out = orig(obj, *args, **kwargs)
            calls.append((self.phase, time.monotonic() - t0,
                          probe(obj, args, kwargs, out) if probe else None))
            return out

        setattr(cls, name, wrapper)
        self._undo.append(lambda: setattr(cls, name, orig))

    def of(self, name, phase=None):
        return [c for c in self.calls[name] if phase in (None, c[0])]

    def undo(self):
        for fn in reversed(self._undo):
            fn()


def same_state(a, b):
    """Bitwise equality of two (nested) state dicts, tensors compared on
    the CPU whatever their devices."""
    if hasattr(a, "cpu"):
        return (hasattr(b, "cpu") and a.dtype == b.dtype
                and a.shape == b.shape and bool((a.cpu() == b.cpu()).all()))
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(same_state(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(map(same_state, a, b)))
    return a == b


def _ckpt_dirs(save):
    return [os.path.join(save, d) for d in sorted(os.listdir(save))
            if d.startswith("CKPT+")]


def phase_trainer(torch):
    """(h) The training harness on the card: cli.pretrain then
    cli.finetune (warm-started from it) on a tiny on-disk corpus of int16
    noise at full width from audio, then load_transcriber on finetune's
    save folder. Returns the VQT kernel launches the path must make."""
    import tempfile

    from piano_a2s_tpu_torch.cli import finetune, pretrain
    from piano_a2s_tpu_torch.config import load_experiment
    from piano_a2s_tpu_torch.infer import load_transcriber
    from piano_a2s_tpu_torch.train.checkpoint import Checkpointer
    from piano_a2s_tpu_torch.train.harness import Trainer
    from piano_a2s_tpu_torch.train.logger import FileTrainLogger
    from piano_a2s_tpu_torch.train.synthetic import write_clips

    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs")
    spy = Spy()
    spy.wrap(Trainer, "_bucketed", lambda t, a, k, out: (
        out["upper"].shape[-1], out["lower"].shape[-1]))
    spy.wrap(Trainer, "_eval_stage")
    spy.wrap(Trainer, "restore", lambda t, a, k, out: (
        len(t.optimizer.state), [g["lr"] for g in t.optimizer.param_groups],
        t.exp.lr))
    spy.wrap(Checkpointer, "save")
    spy.wrap(Checkpointer, "load")
    spy.wrap(FileTrainLogger, "log_stats", lambda lg, a, k, out: k)
    torch.cuda.reset_peak_memory_stats()
    seconds = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            synth = os.path.join(tmp, "feature.score")
            asap = os.path.join(tmp, "feature.asap")
            kw = dict(samples=H_SAMPLES, upper=H_UPPER, lower=H_LOWER)
            for i, (split, n) in enumerate(H_CLIPS.items()):
                write_clips(os.path.join(synth, split, "0"), n, seed=40 + i,
                            **kw)
            for i, (split, n) in enumerate(H_ASAP.items()):
                write_clips(os.path.join(asap, split), n, seed=50 + i, **kw)
            common = [f"workspace={tmp}", "midi_syn=score",
                      "number_of_epochs=1", "input_features=audio",
                      f"batch_size={H_BATCH}"]
            runs = (("pretrain", pretrain, [f"feature_folder={synth}",
                                            "train_versions=1",
                                            "profile_trace_steps=0",
                                            "--profile"]),
                    ("finetune", finetune, [f"feature_folder={asap}"]))
            for name, cli, extra in runs:
                spy.phase = name
                t0 = time.monotonic()
                rc = cli.main([os.path.join(configs, f"{name}.yaml"),
                               *common, *extra, "--device", "cuda"])
                seconds[name] = time.monotonic() - t0
                check(rc == 0, f"(h) {name} exit code")
            out = {name: os.path.join(tmp, "1234", f"{name}.score")
                   for name, _, _ in runs}

            spy.phase = "transcribe"
            save = os.path.join(out["finetune"], "save")
            t0 = time.monotonic()
            tr = load_transcriber(save, device="cuda")
            best = Checkpointer(save).best_path("WER")
            saved = torch.load(os.path.join(best, "model.pt"),
                               map_location="cpu", weights_only=True)
            loaded = tr.model.state_dict()
            check(sorted(loaded) == sorted(saved) and all(
                torch.equal(loaded[k].cpu(), saved[k]) for k in saved),
                "(h) load_transcriber's weights bit-equal to the checkpoint")
            clips = [np.load(os.path.join(asap, "test", "audio",
                                          f"clip{i}.npy"))
                     for i in range(H_TRANSCRIBE)]
            bars = tr.transcribe_batch(clips)
            seconds["transcribe"] = time.monotonic() - t0
            check(len(bars) == H_TRANSCRIBE
                  and all(len(b) == 5 for b in bars), "(h) transcriptions")
            peak = torch.cuda.max_memory_allocated()

            # Checkpoints move between devices: finetune's, saved from the
            # card, restores into a Trainer on the CPU, and one saved there
            # restores into a Trainer on the card, bit for bit.
            spy.phase = "devices"
            t0 = time.monotonic()
            exp = load_experiment(os.path.join(out["finetune"],
                                               "hyperparams.yaml"))
            on_cpu = Trainer(exp, device="cpu")
            on_cpu.restore(best)
            saved_opt = torch.load(os.path.join(best, "optimizer.pt"),
                                   map_location="cpu", weights_only=True)
            check(same_state(on_cpu.model.state_dict(), saved)
                  and same_state(on_cpu.optimizer.state_dict(), saved_opt)
                  and saved_opt["state"],
                  "(h) the card's checkpoint restored on the CPU")
            moved = Checkpointer(os.path.join(tmp, "moved")).save(
                on_cpu._trees(), {"WER": 0.0}, on_cpu._host_state(1))
            on_card = Trainer(exp, device="cuda")
            on_card.restore(moved)
            check(same_state(on_card.model.state_dict(), saved)
                  and same_state(on_card.optimizer.state_dict(), saved_opt)
                  and next(on_card.model.parameters()).is_cuda
                  and all(v.is_cuda for s in on_card.optimizer.state.values()
                          for k, v in s.items() if k != "step"),
                  "(h) the CPU's checkpoint restored on the card")
            seconds["devices"] = time.monotonic() - t0

            with open(os.path.join(out["pretrain"], "profile",
                                   "step_times.json")) as f:
                steps = json.load(f)["train_step"]
            for name in out:
                with open(os.path.join(out[name], "train_log.txt")) as f:
                    for line in f:
                        print(f"(h) {name} train_log: {line.rstrip()}")
                ckpts = _ckpt_dirs(os.path.join(out[name], "save"))
                check(len(ckpts) == 1 and os.path.exists(
                    os.path.join(ckpts[0], "meta.json")),
                    f"(h) one committed checkpoint in {name}'s save folder")
                sizes = {f: os.path.getsize(os.path.join(ckpts[0], f))
                         for f in sorted(os.listdir(ckpts[0]))}
                print(f"(h) {name} checkpoint {os.path.basename(ckpts[0])}:"
                      f" {sum(sizes.values())} bytes on disk {sizes}")
                n_test = H_ASAP["test"] if name == "finetune" else \
                    H_CLIPS["test"]
                n_valid = n_test if name == "finetune" else H_CLIPS["valid"]
                for split, n in (("valid", n_valid), ("test", n_test)):
                    files = os.listdir(os.path.join(out[name], "results",
                                                    split))
                    check(len(files) == n, f"(h) {name} {split} results")
    finally:
        spy.undo()

    caps = {name: [c[2] for c in spy.of("Trainer._bucketed", name)]
            for name in ("pretrain", "finetune")}
    print(f"(h) decode caps (upper, lower) of each train batch: {caps} "
          f"(full caps (398, 189))")
    check(len(caps["pretrain"]) == -(-H_CLIPS["train"] // H_BATCH)
          and len(caps["finetune"]) == -(-H_ASAP["train"] // H_BATCH),
          "(h) train batches")
    check(all(u < 398 and lo < 189 for u, lo in
              caps["pretrain"] + caps["finetune"]), "(h) bucketed caps")
    print(f"(h) seconds per train step (pretrain, step_times.json): mean "
          f"{steps['mean_s']:.3f}, min {steps['min_s']:.3f}, max "
          f"{steps['max_s']:.3f} over {steps['count']}")
    for name in ("Trainer._eval_stage", "Checkpointer.save",
                 "Checkpointer.load"):
        print(f"(h) {name} seconds: " + ", ".join(
            f"{ph} {s:.3f}" for ph, s, _ in spy.of(name)))
    print(f"(h) wall seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in seconds.items())
        + f"; peak device memory {peak / 2**30:.2f} GiB")
    for phase, _, stages in spy.of("FileTrainLogger.log_stats"):
        for stage, stats in stages.items():
            if stage != "stats_meta":
                check(np.isfinite(stats["loss"]),
                      f"(h) {phase} {stage} loss finite")
    restores = spy.of("Trainer.restore", "finetune")
    print(f"(h) restores (optimizer state entries, lr, exp.lr): "
          f"{[c[2] for c in spy.of('Trainer.restore')]}")
    n_state, lrs, lr = restores[0][2]
    check(n_state == 0 and lrs == [lr],
          "(h) finetune's warm start ran a fresh Adadelta at exp.lr")
    check(spy.of("Trainer.restore", "pretrain")[0][2][0] > 0,
          "(h) pretrain's evaluate restored the optimizer state")

    def batches(n):
        return -(-n // H_BATCH)

    # One launch per train and eval batch on the path, and one per
    # transcribe call.
    return (batches(H_CLIPS["train"]) + batches(H_CLIPS["valid"])
            + batches(H_CLIPS["test"]) + batches(H_ASAP["train"])
            + 2 * batches(H_ASAP["test"]) + 1)


def write_short_songs(base, n_songs, seed):
    """(k1) ``n_songs`` songs of synth.make_song with K_UPPER_NOTES and
    K_LOWER_NOTES notes a bar, written with the module's own _write_song
    (direct host VQT, float32 audio) into ``base`` (a {split}/{version}
    folder). Returns the seconds per song."""
    from piano_a2s_tpu_torch.data import synth
    from piano_a2s_tpu_torch.ops.vqt import VQTConfig, get_vqt_host
    for sub in ("target", "info", "spectrogram", "audio"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    t0 = time.monotonic()
    for s in range(n_songs):
        target, audio = synth.make_song(rng, upper_notes=K_UPPER_NOTES,
                                        lower_notes=K_LOWER_NOTES)
        chunk = f"short{seed}_{s:03d}"
        synth._write_song(base, chunk, f"{chunk}~v0~Upright", target, audio,
                          get_vqt_host, VQTConfig(), 1201, True, 5)
    return (time.monotonic() - t0) / n_songs


def phase_synth_features(torch, tvqt, folders):
    """(k2) Each clip's stored float32 audio/*.npy, zero-padded to 12 s as
    the loader pads it, through get_vqt on the card (the VQT kernel) and
    through the plain f32 version, each against the stored
    host spectrogram over the clip's own 1 + L // 160 frames. Returns the
    largest error of each."""
    paths = sorted(os.path.join(f, "audio", n) for f in folders
                   for n in os.listdir(os.path.join(f, "audio")))
    audio = [np.load(p) for p in paths]
    host = [np.load(p.replace(os.sep + "audio" + os.sep,
                              os.sep + "spectrogram" + os.sep))
            for p in paths]
    check(all(a.dtype == np.float32 for a in audio), "(k2) float32 audio")
    y = torch.tensor(np.stack([np.pad(a, (0, CLIP_SAMPLES - len(a)))
                               for a in audio]), device="cuda")
    cfg = tvqt.VQTConfig()
    kernels = tvqt.filters(cfg, "cuda")
    with torch.inference_mode():
        got = tvqt.get_vqt(y, kernels, cfg).cpu().numpy()
        plain = tvqt.log_compress(tvqt.vqt_magnitude_torch(y, kernels, cfg))
        plain = plain.cpu().numpy()
    err = {"kernel": 0.0, "plain": 0.0}
    for i, (a, h) in enumerate(zip(audio, host)):
        n = 1 + len(a) // cfg.hop_length
        check(h.shape == (n, cfg.n_bins), f"(k2) stored spectrogram {i}")
        err["kernel"] = max(err["kernel"], float(np.abs(got[i, :n] - h).max()))
        err["plain"] = max(err["plain"], float(np.abs(plain[i, :n] - h).max()))
    print(f"(k2) {len(paths)} clips of {sorted({len(a) for a in audio})} "
          f"samples: get_vqt on the card against the stored host "
          f"spectrograms, max|difference| {err['kernel']:.3e} (atol "
          f"{TOL_SPEC}); the plain f32 version's {err['plain']:.3e}")
    check(err["kernel"] <= TOL_SPEC, "(k2) the VQT kernel gives the host "
          "feature pass's spectrograms")
    return err


def memorized(preds, batch, eos):
    """(every bar of both staves emitted EOS, the share of tokens plus EOS
    equal to the targets) of a greedy decode: tests/test_overfit.py's
    measure, over both staves."""
    stopped, matches, total = True, 0, 0
    for staff in ("upper", "lower"):
        tok = preds[f"{staff}_tokens"].cpu().numpy()
        gt, lens = batch[staff], batch[f"{staff}_lengths"]
        stopped &= bool((tok == eos).any(-1).all())
        for i in range(gt.shape[0]):
            for m in range(gt.shape[1]):
                n = int(lens[i, m]) + 1
                total += n
                matches += int((tok[i, m, :n] == gt[i, m, :n]).sum())
    return stopped, matches / total


def memorize_batch(folder, n_clips, cfg):
    """(k3)'s batch: every clip of ``folder`` (a {split}/{version} folder
    of the synth layout) through the port's SyntheticTrainDataset and
    DataLoader from audio, the target arrays cut to the longest target
    plus EOS (the teacher-forced decode runs to their width; the cut
    positions are all <pad>)."""
    from piano_a2s_tpu_torch.data.datasets import (DataLoader,
                                                   SyntheticTrainDataset)
    split_dir, version = os.path.split(os.path.normpath(folder))
    root, split = os.path.split(split_dir)
    ds = SyntheticTrainDataset(root, split, versions=[int(version)],
                               max_length=cfg.max_length,
                               input_features="audio",
                               rng=np.random.RandomState(0))
    (batch,) = list(DataLoader(ds, n_clips, shuffle=False))
    batch = {k: v for k, v in batch.items()
             if k not in ("names", "versions", "n_real")}
    for staff in ("upper", "lower"):
        width = int(batch[f"{staff}_lengths"].max()) + 1
        batch[staff] = batch[staff][..., :width]
    return batch


def phase_memorize(torch, tmodels, tstep, tvqt, batch, cfg):
    """(k3) Train the model of seed 0 on one fixed batch from audio (the
    VQT kernel inside every step on the card) with Adadelta at lr 1.0, tf
    K_TF, until the greedy decode (eval-mode BatchNorm, e_step) of the
    batch emits EOS in every bar of both staves and matches its targets
    above K_MATCH; checked every K_EVAL_EVERY steps. Fails at the step
    cap. Returns (state dict, steps, evals)."""
    model = tmodels.ScoreTranscription(cfg)
    model.load_state_dict(tmodels.init_state_dict(cfg, seed=0), strict=True)
    model.to("cuda")
    t_step, e_step = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters(), lr=1.0), from_audio=True,
        vqt_cfg=tvqt.VQTConfig(), max_frame_num=1201)
    gen = torch.Generator("cuda").manual_seed(0)
    losses, evals, match, stopped = [], 0, 0.0, False
    t0 = time.monotonic()
    step = 0
    while step < K_MAX_STEPS and not (stopped and match > K_MATCH):
        step += 1
        out = t_step(model, batch, gen, K_TF)
        losses.append(float(out.loss))
        check(np.isfinite(losses[-1]), f"(k3) step {step} finite loss")
        if step % K_EVAL_EVERY == 0:
            _, preds = e_step(model, batch)
            evals += 1
            stopped, match = memorized(preds, batch, cfg.eos)
            print(f"(k3) step {step}: loss {losses[-1]:.4f}; greedy decode "
                  f"EOS in every bar {stopped}, match {match:.3f} "
                  f"({time.monotonic() - t0:.1f} s)")
    seconds = time.monotonic() - t0
    print(f"(k3) memorized {batch['audio'].shape[0]} clips at width "
          f"(upper {batch['upper'].shape[-1]}, lower "
          f"{batch['lower'].shape[-1]}) in {step} steps and {evals} greedy "
          f"decodes, {seconds:.1f} s ({seconds / step:.3f} s a step with the "
          f"decodes); loss first {losses[0]:.4f}, last {losses[-1]:.4f}; "
          f"match {match:.3f} (above {K_MATCH}), EOS in every bar {stopped}"
          f"; step cap {K_MAX_STEPS}")
    check(stopped and match > K_MATCH,
          f"(k3) memorized before the step cap of {K_MAX_STEPS}")
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            step, evals)


def decode_steps_a_bar(tr, clips):
    """Mean over bars of the greedy loop's steps (the largest length over
    the batch and both staves: an item's length is its last EOS step + 1,
    the loop stops a staff when every item has emitted one)."""
    arrays = tr._to_host(tr._infer_audio(tr.prepare_batch(clips)[0]))
    up_len, low_len = arrays[4].astype(int), arrays[5].astype(int)
    return float(np.maximum(up_len.max(0), low_len.max(0)).mean())


def phase_early_exit(Transcriber, state_dict, random_state_dict, cfg, batch,
                     kernel):
    """(k4) A Transcriber of (k3)'s state dict on its clips tiled to a
    batch of N_CLIPS: one transcribe_batch (the path's; its results held
    against the targets), then clips/s in turns with the random-weight
    Transcriber of (e) on the same clips, and the mean decode steps a bar
    of each. Returns the kernel's launches after the path call."""
    audio = batch["audio"]
    clips = [audio[i % len(audio)] for i in range(N_CLIPS)]
    trained = Transcriber(state_dict, cfg, device="cuda")
    results = trained.transcribe_batch(clips)
    launches = kernel.launches
    matches = total = 0
    for i, bars in enumerate(results[:len(audio)]):
        for m, (_, _, lower, upper) in enumerate(bars):
            for staff, got in (("upper", upper), ("lower", lower)):
                n = int(batch[f"{staff}_lengths"][i, m])
                ref = list(batch[staff][i, m, :n])
                total += n
                matches += sum(int(a == b) for a, b in zip(got, ref))
    print(f"(k4) the memorized Transcriber's tokens equal to the targets: "
          f"{matches}/{total}")
    rand = Transcriber(random_state_dict, cfg, device="cuda")
    turns = {"memorized": [], "random": []}
    for name, tr in (("memorized", trained), ("random", rand),
                     ("random", rand), ("memorized", trained)):
        t0 = time.monotonic()
        tr.transcribe_batch(clips)
        turns[name].append(time.monotonic() - t0)
    rate = {k: N_CLIPS / float(np.median(v)) for k, v in turns.items()}
    steps = {"memorized": decode_steps_a_bar(trained, clips),
             "random": decode_steps_a_bar(rand, clips)}
    print(f"(k4) transcribe_batch of {N_CLIPS} clips ({len(audio)} memorized "
          f"clips tiled) in turns memorized, random, random, memorized: "
          + ", ".join(f"{k} {[round(t, 3) for t in v]} s ({rate[k]:.2f} "
                      f"clips/s, {steps[k]:.1f} decode steps a bar)"
                      for k, v in turns.items())
          + f"; early exit / cap-bound clips/s "
          f"{rate['memorized'] / rate['random']:.3f}")
    check(steps["memorized"] < max(cfg.max_length),
          "(k4) the memorized model exits early")
    return launches


def phase_synth(torch, tmodels, tstep, tvqt, Transcriber, random_state_dict,
                kernel, corpus):
    """(k) The synth path at full width: (k1) the corpus under ``corpus``,
    whose K_CLIPS short songs make its test split ({corpus}/test/0, which
    (l) evaluates), (k2) its stored spectrograms against the VQT kernel,
    then the path with the kernel's launch count zeroed first: (k3)
    memorize, (k4) the memorized Transcriber's batch; then (k4)'s turns.
    Returns (the path's launches, (k3)'s state dict)."""
    from piano_a2s_tpu_torch.data import synth

    cfg = tmodels.ModelConfig()
    t0 = time.monotonic()
    synth.write_corpus(corpus, "train", K_CORPUS_SONGS, seed=K_SEED,
                       frontend="direct", save_audio=True)
    corpus_s = (time.monotonic() - t0) / K_CORPUS_SONGS
    short = os.path.join(corpus, "test", "0")
    short_s = write_short_songs(short, K_CLIPS, K_SEED)
    print(f"(k1) write_corpus: {K_CORPUS_SONGS} songs, {corpus_s:.3f} "
          f"host s a song; {K_CLIPS} songs of {K_UPPER_NOTES} upper and "
          f"{K_LOWER_NOTES} lower notes a bar, {short_s:.3f} host s a "
          f"song (direct host VQT, float32 audio)")
    phase_synth_features(torch, tvqt,
                         [os.path.join(corpus, "train", "0"), short])
    batch = memorize_batch(short, K_CLIPS, cfg)
    gc.collect()
    kernel.launches = 0
    state_dict, steps, evals = phase_memorize(torch, tmodels, tstep, tvqt,
                                              batch, cfg)
    launches = phase_early_exit(Transcriber, state_dict, random_state_dict,
                                cfg, batch, kernel)
    print(f"(k) vqt kernel launches over (k3) and (k4)'s path call: "
          f"{launches} (expected {steps + evals + 1}: one a train step, a "
          f"greedy decode and a transcribe_batch)")
    check(launches == steps + evals + 1, "(k) one vqt launch per train step, "
          "greedy decode and transcribe_batch")
    return launches, state_dict


def run_evaluate(label, configs, corpus, out):
    """The port's evaluate command in this process on ``out``'s test
    results, native MV2H and MUSTER; its lines printed under ``label``.
    Returns the host seconds a clip of the export, the MV2H and the
    MUSTER scoring."""
    import piano_a2s_tpu_torch.train.evaluate_offline as toffline
    import piano_a2s_tpu_torch.train.muster as tmuster
    import piano_a2s_tpu_torch.train.mv2h as tmv2h
    from piano_a2s_tpu_torch.cli import evaluate as tevaluate

    spy = Spy()
    stages = {"export": (toffline, "export_target"),
              "mv2h": (tmv2h, "run_native_mv2h_pair"),
              "muster": (tmuster, "native_muster_pair")}
    for module, name in stages.values():
        spy.wrap(module, name)
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            rc = tevaluate.main([
                os.path.join(configs, "pretrain.yaml"),
                f"workspace={os.path.dirname(out)}", f"output_folder={out}",
                f"feature_folder={corpus}", "--mv2h-engine", "native",
                "--muster", "--muster-engine", "native"])
    finally:
        spy.undo()
    for line in text.getvalue().splitlines():
        print(f"{label} evaluate: {line.replace(out, '<out>')}")
    check(rc == 0, f"{label} the evaluate command's exit code")
    n = len(os.listdir(os.path.join(out, "results", "test")))
    return {stage: sum(c[1] for c in spy.of(f"{module.__name__}.{name}")) / n
            for stage, (module, name) in stages.items()}


def read_scores(out):
    """(export errors, per-clip MV2H dicts, the synthetic summary of the
    test split, the native MUSTER rates and their pair count) of an
    evaluated output folder."""
    import piano_a2s_tpu_torch.train.evaluate_offline as toffline

    with open(os.path.join(out, "results", "errors.txt")) as f:
        errors = f.read().split()
    mv2h_dir = os.path.join(out, "results", "mv2h")
    clips = {}
    for name in sorted(os.listdir(mv2h_dir)):
        with open(os.path.join(mv2h_dir, name)) as f:
            clips[name[:-len("_mv2h.json")]] = json.load(f)
    summary = toffline.summarize_syn_mv2h(out, split="test")
    ers, pairs = toffline.get_muster_er(out, engine="native", split="test")
    return errors, clips, summary, ers, pairs


def phase_evaluate(torch, corpus, state_dict, kernel):
    """(l) The offline evaluation path at full width: (l1) the Trainer's
    test stage on the card over (k)'s test split from audio with (k3)'s
    weights (the VQT kernel once an eval batch; its launch count zeroed
    just before), (l2) the evaluate command on a copy of its records whose
    predictions are the targets, (l3) on the records themselves. Returns
    the path's launches."""
    import pickle
    import tempfile

    from piano_a2s_tpu_torch.config import load_experiment
    from piano_a2s_tpu_torch.data.datasets import (DataLoader,
                                                   SyntheticTestDataset)
    from piano_a2s_tpu_torch.train.harness import Trainer
    from piano_a2s_tpu_torch.train.muster import MUSTER_COMPONENTS
    from piano_a2s_tpu_torch.train.mv2h import MV2H_KEYS

    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs")
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        exp = load_experiment(os.path.join(configs, "pretrain.yaml"), [
            f"workspace={tmp}", "midi_syn=score", f"feature_folder={corpus}",
            f"output_folder={run}", "input_features=audio",
            f"batch_size={L_BATCH}"])
        t0 = time.monotonic()
        trainer = Trainer(exp, device="cuda", state_dict=state_dict)
        test = SyntheticTestDataset(corpus, "test", versions=[0],
                                    **exp.dataset_kwargs())
        loader = DataLoader(test, exp.batch_size)
        build_s = time.monotonic() - t0
        kernel.launches = 0
        t0 = time.monotonic()
        stats = trainer.evaluate(loader)
        stage_s = time.monotonic() - t0
        launches = kernel.launches
        results = os.path.join(run, "results", "test")
        records = sorted(os.listdir(results))
        n_batches = -(-len(test) // L_BATCH)
        print(f"(l1) Trainer.evaluate on the card over {len(test)} clips "
              f"from audio, batch {L_BATCH}: {stage_s:.3f} s (Trainer and "
              f"loader built in {build_s:.3f} s); WER {stats['WER']:.4f} "
              f"(upper {stats['WER_upper']:.4f}, lower "
              f"{stats['WER_lower']:.4f}), key F1 {stats['key_f1']:.4f}, "
              f"time-signature F1 {stats['time_f1']:.4f}; vqt kernel "
              f"launches {launches} over {n_batches} eval batch(es); "
              f"records {records}")
        check(len(test) == K_CLIPS and len(records) == K_CLIPS,
              "(l1) one result JSON per clip")
        check(launches == n_batches, "(l1) one vqt launch per eval batch")

        # (l2) Identity: each prediction replaced by the clip's own target.
        ident = os.path.join(tmp, "identity")
        os.makedirs(os.path.join(ident, "results", "test"))
        for name in records:
            with open(os.path.join(results, name)) as f:
                record = json.load(f)
            with open(record["target_path"], "rb") as f:
                record["pred"] = pickle.load(f)
            with open(os.path.join(ident, "results", "test", name),
                      "w") as f:
                json.dump(record, f, indent=2)
        ident_s = run_evaluate("(l2)", configs, corpus, ident)
        errors, clips, (mean, four, n), ers, pairs = read_scores(ident)
        print(f"(l2) identity: export errors {len(errors)}, {n} clips "
              f"summarized, MV2H {mean}, MUSTER {ers.tolist()} over {pairs} "
              f"pairs; host s a clip {ident_s}")
        check(not errors and n == K_CLIPS and len(clips) == K_CLIPS
              and all(c[k] == 1.0 for c in clips.values() for k in MV2H_KEYS),
              "(l2) every clip's prediction equal to its target scores MV2H "
              "1.0 on every key")
        check(pairs == K_CLIPS and len(ers) == 11 and not ers.any(),
              "(l2) MUSTER all zeros")

        # (l3) The memorized model's own predictions.
        model_s = run_evaluate("(l3)", configs, corpus, run)
        errors, clips, (mean, four, n), ers, pairs = read_scores(run)
        for clip_id, scores in clips.items():
            print(f"(l3) {clip_id}: " + ", ".join(
                f"{k} {scores[k]:.4f}" for k in MV2H_KEYS))
        print(f"(l3) memorized model: export errors {len(errors)} of "
              f"{K_CLIPS} {errors}; mean over {n} clips "
              + ", ".join(f"{k} {mean[k]:.4f}" for k in MV2H_KEYS)
              + f"; 4-way mean {four:.4f}; MUSTER over {pairs} pairs "
              + ", ".join(f"{c} {e:.4f}" for c, e in
                          zip(MUSTER_COMPONENTS, ers))
              + "; host s a clip " + ", ".join(
                  f"{k} {v:.4f}" for k, v in model_s.items()))
        check(n == len(clips), "(l3) the summary counts every clip with an "
              "MV2H JSON")
        check(len(errors) <= L_MAX_ERRORS,
              f"(l3) at most {L_MAX_ERRORS} export error(s)")
        check(mean["MV2H"] >= L_MIN_MV2H,
              f"(l3) mean MV2H {mean['MV2H']:.4f} at least {L_MIN_MV2H}")
    return launches


def save_folder_of(tmodels, tstep, state_dict, folder):
    """(n) ``state_dict`` saved once through the port's Checkpointer as a
    save folder of its training commands (WER 0, a fresh Adadelta), which
    each tool loads as a user would. Returns the folder."""
    from piano_a2s_tpu_torch.train.checkpoint import Checkpointer
    model = tmodels.ScoreTranscription(tmodels.ModelConfig())
    model.load_state_dict({k: v.cpu() for k, v in state_dict.items()},
                          strict=True)
    Checkpointer(folder).save(
        {"model": model.state_dict(),
         "optimizer": tstep.make_optimizer(model.parameters()).state_dict()},
        {"WER": 0.0}, {"epoch": 1, "fresh_optimizer": True})
    return folder


def phase_frontend_ab(save, corpus, out, kernel):
    """(n1) tools.frontend_ab.main on (k)'s test split: side A from the
    stored host spectrograms, side B from audio through the VQT kernel, one
    launch a clip (its count zeroed just before). Returns the launches."""
    from piano_a2s_tpu_torch.tools import frontend_ab

    n_clips = len(os.listdir(os.path.join(corpus, "test", "0", "audio")))
    kernel.launches = 0
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()):
        report = frontend_ab.main([save, corpus, "--split", "test",
                                   "--out", out])
    seconds = time.monotonic() - t0
    launches = kernel.launches
    with open(out) as f:
        written = json.load(f)
    wer = report["wer_vs_target"]
    gap = max(abs(wer[f"oracle_spectrogram_{s}"] - wer[f"ondevice_vqt_{s}"])
              for s in ("upper", "lower"))
    print(f"(n1) frontend A/B over {report['clips']} clips in {seconds:.2f} "
          f"s (the Transcriber's load included): {json.dumps(report)}; WER "
          f"gap {gap:.4f} (at most {N_MAX_WER_GAP}); vqt kernel launches "
          f"{launches}")
    check(written == report, "(n1) the report written to --out")
    check(report["clips"] == n_clips and launches == n_clips,
          "(n1) one vqt launch a clip (side B)")
    check(report["ts_agreement"] == 1.0 and report["key_agreement"] == 1.0,
          "(n1) the time and key signatures of both frontends agree")
    check(min(report["upper_token_agreement"],
              report["lower_token_agreement"]) >= N_MIN_TOKEN_AGREEMENT,
          f"(n1) token agreement at least {N_MIN_TOKEN_AGREEMENT} a staff")
    check(gap <= N_MAX_WER_GAP, f"(n1) WER gap at most {N_MAX_WER_GAP}")
    return launches


def phase_inspect_attention(save, corpus, tmp, kernel):
    """(n2) tools.inspect_attention.main on (k)'s test split from audio,
    clip 0, bar 0, the upper then the lower staff; each call one VQT kernel
    launch (its count zeroed just before). Returns the launches."""
    import pickle

    from piano_a2s_tpu_torch.tools import inspect_attention

    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs")
    audio = os.path.join(corpus, "test", "0", "audio")
    first = sorted(os.listdir(audio))[0][:-len(".npy")]
    with open(os.path.join(corpus, "test", "0", "target",
                           f"{first.split('~')[0]}.pkl"), "rb") as f:
        bar0 = pickle.load(f)[0]
    total = 0
    for staff, tokens in (("upper", bar0[3]), ("lower", bar0[2])):
        kernel.launches = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rows = inspect_attention.main([
                "--checkpoint", save, "--config",
                os.path.join(configs, "pretrain.yaml"), "--feature-folder",
                corpus, "--split", "test", "--clip", "0", "--bar", "0",
                "--staff", staff, f"workspace={tmp}", "midi_syn=score",
                f"output_folder={tmp}/n2", "input_features=audio"])
        seconds = time.monotonic() - t0
        launches = kernel.launches
        total += launches
        for line in text.getvalue().splitlines()[:2]:
            print(f"(n2) {line}")
        acc = float(np.mean([r["pred"] == r["gt"] for r in rows]))
        entropy = float(np.mean([r["entropy"] for r in rows]))
        aligned = float(np.mean([abs(r["argmax_frame"] - r["expected_frame"])
                                 <= N_ALIGN_FRAMES for r in rows]))
        print(f"(n2) {staff}: {len(rows)} steps (the bar's target has "
              f"{len(tokens)}) in {seconds:.2f} s (the Trainer's build "
              f"included); tf accuracy {acc:.3f} (at least "
              f"{N_MIN_TF_ACCURACY}); mean attention entropy {entropy:.3f} "
              f"against the uniform {np.log(1201):.3f}; argmax within "
              f"{N_ALIGN_FRAMES} frames of the expected frame in "
              f"{aligned:.3f} of the steps; rows "
              + "; ".join(f"{r['step']} {r['entropy']:.3f} "
                          f"{r['argmax_frame']} {r['expected_frame']} "
                          f"{r['gt']}/{r['pred']}" for r in rows)
              + f"; vqt kernel launches {launches}")
        check(launches == 1, "(n2) one vqt launch a call")
        check(len(rows) == len(tokens), "(n2) one row a target token")
        check(acc >= N_MIN_TF_ACCURACY,
              f"(n2) teacher-forced accuracy at least {N_MIN_TF_ACCURACY}")
    return total


def phase_load_test(load_transcriber, make_server, save, corpus, kernel):
    """(n3) tools.load_test.main against the port's server in this process
    (a Transcriber of the save folder on the card, warmed as the server
    command warms it, dynamic batches of at most N_MAX_BATCH), N_CLIENTS
    clients sending N_REQUESTS of (k)'s test clips; one VQT kernel launch a
    dynamic batch (its count zeroed just before). Then each distinct clip's HTTP results against
    Transcriber.transcribe of that clip alone. Returns the launches."""
    from piano_a2s_tpu_torch.serve import warm
    from piano_a2s_tpu_torch.tools import load_test

    tr = load_transcriber(save, device="cuda")
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()):
        warm(tr, N_MAX_BATCH)  # as the server command does before traffic
    print(f"(n3) warmed every padded batch size up to {N_MAX_BATCH} in "
          f"{time.monotonic() - t0:.2f} s")
    served = {}  # each prepared clip's bytes -> (clip, its results)

    def recording(audio, n, timings=None):
        results = tr_prepared(audio, n, timings=timings)
        for row, res in zip(audio[:n], results):
            served.setdefault(row.tobytes(), (row.copy(), []))[1].append(res)
        return results

    tr_prepared = tr.transcribe_prepared
    tr.transcribe_prepared = recording
    httpd = make_server(tr, "127.0.0.1", 0, max_batch=N_MAX_BATCH)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        kernel.launches = 0
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = load_test.main([
                "--url", url, "--clients", str(N_CLIENTS), "--clips",
                str(N_REQUESTS), "--audio-dir",
                os.path.join(corpus, "test", "0", "audio")])
        launches = kernel.launches
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            stats = json.load(r)
    finally:
        httpd.shutdown()
        httpd.service.close()
        thread.join(timeout=30)
        del tr.transcribe_prepared
    report = json.loads(text.getvalue().strip().splitlines()[-1])
    differ = sum(any(res != tr.transcribe(row) for res in results)
                 for row, results in served.values())
    print(f"(n3) load test, {N_CLIENTS} clients, {N_REQUESTS} requests over "
          f"{len(served)} distinct clips, max batch {N_MAX_BATCH}: ok "
          f"{report['ok']}, errors {report['errors']}, wall "
          f"{report['wall_s']} s, {report['clips_per_sec']} clips/s; server "
          f"batches {stats['batches']}, clips per batch "
          f"{stats['clips_per_batch']}, "
          + ", ".join(f"{k} {v}" for k, v in sorted(stats.items())
                      if k.endswith("_ms_per_batch"))
          + f"; vqt kernel launches {launches}; distinct clips whose HTTP "
          f"results differ from Transcriber.transcribe alone: {differ} of "
          f"{len(served)}")
    check(rc == 0 and report["ok"] == N_REQUESTS and report["errors"] == 0,
          f"(n3) {N_REQUESTS} requests answered, no error")
    check(launches == stats["batches"] > 0,
          "(n3) one vqt launch a dynamic batch")
    check(not thread.is_alive(), "(n3) server thread stopped")
    return launches


def phase_diagnostics(tmodels, tstep, load_transcriber, make_server, corpus,
                      state_dict, kernel):
    """(n) The three diagnostic tools on (k)'s corpus with (k3)'s weights,
    saved once into a save folder: (n1) frontend A/B, (n2) the attention
    probe, (n3) the HTTP load test, each path with its own launch count.
    Returns the launches by path."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="diagnostics_") as tmp:
        save = save_folder_of(tmodels, tstep, state_dict,
                              os.path.join(tmp, "save"))
        launches = {}
        for name, run in (
                ("frontend_ab", lambda: phase_frontend_ab(
                    save, corpus, os.path.join(tmp, "ab.json"), kernel)),
                ("inspect_attention", lambda: phase_inspect_attention(
                    save, corpus, tmp, kernel)),
                ("load_test", lambda: phase_load_test(
                    load_transcriber, make_server, save, corpus, kernel))):
            t0 = time.monotonic()
            launches[name] = run()
            print(f"(n) {name} took {time.monotonic() - t0:.1f} s")
    return launches


def m_kern_folder(kern):
    """(m1) The real-score excerpts copied into ``kern``, the first renamed
    to the first song of the port's test_split.txt and the second to that
    of valid_split.txt. Returns {song: split}."""
    from piano_a2s_tpu_torch.data.datasets import load_split_list
    names = sorted(f for f in os.listdir(M_FIXTURES) if f.endswith(".krn"))
    check(len(names) == 4, "(m1) four real-score excerpts")
    routes = [(load_split_list("test_split.txt")[1], "test"),
              (load_split_list("valid_split.txt")[1], "valid")]
    os.makedirs(kern)
    songs = {}
    for i, name in enumerate(names):
        song, split = routes[i] if i < len(routes) else (name[:-4], "train")
        with open(os.path.join(M_FIXTURES, name), "rb") as f, \
                open(os.path.join(kern, f"{song}.krn"), "wb") as g:
            g.write(f.read())
        songs[song] = split
    return songs


def phase_native_tools():
    """(m1) The port's native kern library is built and loaded, and gives
    its Python twins' strings on every excerpt: both staves extracted, the
    ties repaired and every transposition of FEASIBLE_TRANSPOSES[0]."""
    from piano_a2s_tpu_torch.data.render import FEASIBLE_TRANSPOSES
    from piano_a2s_tpu_torch.symbolic import native

    t0 = time.monotonic()
    check(native.native_available(), "(m1) the native kern library loads")
    path = native._load_lib()._name
    check(os.path.dirname(path) == native.BUILD_DIR,
          "(m1) the library is the port's own build")
    build_s = time.monotonic() - t0
    n = 0
    for name in sorted(os.listdir(M_FIXTURES)):
        if not name.endswith(".krn"):
            continue
        with open(os.path.join(M_FIXTURES, name), encoding="iso-8859-1") as f:
            text = f.read()
        pairs = [(native.extract_spine(text, s),
                  native._py_extract_spine(text, s)) for s in (1, 2)]
        pairs.append((native.tiefix_kern(text), native._py_tiefix(text)))
        pairs += [(native.transpose_kern(text, str(iv)),
                   native._py_transpose(text, str(iv)))
                  for iv in FEASIBLE_TRANSPOSES[0]]
        for got, want in pairs:
            check(got == want, f"(m1) native kern tool equal to its twin on "
                               f"{name}")
        n += len(pairs)
    print(f"(m1) native kern tools: {os.path.basename(path)} built and "
          f"loaded in {build_s:.2f} s; {n} calls on 4 excerpts equal to the "
          f"Python twins")


def clean_rule_breakers(feature_folder, versions):
    """The MIDI files (relative paths) that clean_files' rules remove: no
    target, longer than 12 s, a pitch outside 21..108, or a bar's key or
    time signature out of range."""
    import pickle

    from piano_a2s_tpu_torch.data.datasets import load_time_signatures
    from piano_a2s_tpu_torch.symbolic.midi_io import read_midi

    time_sigs = load_time_signatures()
    bad = set()
    for split in ("train", "valid", "test"):
        for v in versions:
            folder = os.path.join(feature_folder, split, str(v))
            midi_dir = os.path.join(folder, "midi")
            if not os.path.isdir(midi_dir):
                continue
            for midi in sorted(os.listdir(midi_dir)):
                rel = os.path.join(split, str(v), "midi", midi)
                target = os.path.join(folder, "target", f"{midi[:-4]}.pkl")
                if not os.path.exists(target):
                    bad.add(rel)
                    continue
                notes = read_midi(os.path.join(midi_dir, midi)).notes()
                with open(target, "rb") as f:
                    bars = pickle.load(f)
                if max((n[1] for n in notes), default=0.0) > 12 or any(
                        not 21 <= n[2] <= 108 for n in notes) or any(
                        not -6 <= b[0] <= 7 or b[1] not in time_sigs
                        for b in bars):
                    bad.add(rel)
    return bad


def corpus_files(corpus, versions):
    """{(split, version): {sub: sorted names}} of the synth layout."""
    out = {}
    for split in ("train", "valid", "test"):
        for v in versions:
            folder = os.path.join(corpus, split, str(v))
            out[split, v] = {
                sub: sorted(os.listdir(os.path.join(folder, sub)))
                if os.path.isdir(os.path.join(folder, sub)) else []
                for sub in ("target", "midi", "wav", "spectrogram", "audio")}
    return out


def phase_prepare_corpus(tmp):
    """(m1) The score side of the data preparation through the port's
    command in this process: the four excerpts -> preprocess, split, midi
    (the native EPR engine), clean, render (the stand-in synthesizer),
    spectrograms, M_VERSIONS versions. Returns (corpus folder, the files of
    each split and version)."""
    import pickle

    import piano_a2s_tpu_torch.cli.prepare_data as tprepare
    from piano_a2s_tpu_torch.data import render
    from piano_a2s_tpu_torch.data.datasets import load_time_signatures
    from piano_a2s_tpu_torch.symbolic.vocab import LabelsMultiple

    phase_native_tools()
    songs = m_kern_folder(os.path.join(tmp, "kern"))
    corpus = os.path.join(tmp, "feature.epr")
    bindir = os.path.join(tmp, "bin")
    os.makedirs(bindir)
    synth = os.path.join(bindir, "fluidsynth")
    with open(synth, "w") as f:
        f.write(FLUIDSYNTH_STANDIN.format(
            python=sys.executable,
            repo=os.path.dirname(os.path.abspath(__file__))))
    os.chmod(synth, 0o755)
    versions = list(range(M_VERSIONS))
    predicted = {}
    spy = Spy()
    spy.wrap(tprepare, "_pool_map",
             lambda work, a, k, out: work.func.__name__)
    spy.wrap(render, "preprocess_kern")
    spy.wrap(render, "xml_to_midi", lambda *_: predicted.update(
        bad=clean_rule_breakers(corpus, versions),
        before=corpus_files(corpus, versions)))
    spy.wrap(render, "clean_files", lambda v, a, k, out: out)
    path = os.environ["PATH"]
    os.environ["PATH"] = f"{bindir}{os.pathsep}{path}"
    text = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(text):
            rc = tprepare.main([
                "syn", os.path.join(os.path.dirname(os.path.abspath(
                    __file__)), "configs", "pretrain.yaml"),
                "preprocess", "split", "midi", "clean", "render",
                "spectrograms", f"workspace={tmp}", "midi_syn=epr",
                "epr_engine=native", f"train_versions={M_VERSIONS}",
                f"feature_folder={corpus}",
                f"soundfont_folder={os.path.join(tmp, 'soundfonts')}",
                "--kern-folder", os.path.join(tmp, "kern"),
                "--xml-folder", os.path.join(tmp, "xml")])
    finally:
        os.environ["PATH"] = path
        spy.undo()
    seconds = time.monotonic() - t0
    for line in text.getvalue().splitlines():
        print(f"(m1) prepare_data: {line.replace(tmp, '<tmp>')}")
    check(rc == 0, "(m1) prepare_data's exit code")
    print("(m1) the synthesizer was a stand-in for FluidSynth (additive "
          "synthesis, a timbre seeded from each soundfont's name): no "
          "FluidSynth or soundfont is installed")

    files = corpus_files(corpus, versions)
    print("(m1) per split and version, (chunks with targets, MIDI files, "
          "WAVs, spectrograms): " + ", ".join(
              f"{s}/{v} ({len(f['target'])}, {len(f['midi'])}, "
              f"{len(f['wav'])}, {len(f['spectrogram'])})"
              for (s, v), f in files.items()))
    labels = LabelsMultiple(extended=True)
    time_sigs = load_time_signatures()
    removed = {os.path.join(s, str(v), "midi", m)
               for (s, v), subs in predicted["before"].items()
               for m in subs["midi"] if m not in files[s, v]["midi"]}
    check(removed == predicted["bad"], f"(m1) clean_files removed "
          f"{sorted(removed)}, its rules {sorted(predicted['bad'])}")
    clips = 0
    for (split, v), subs in files.items():
        for target in subs["target"]:
            song = target.split(".")[0]
            check(songs[song] == split, f"(m1) {song} routed to {split}")
            with open(os.path.join(corpus, split, str(v), "target", target),
                      "rb") as f:
                bars = pickle.load(f)
            check(len(bars) == 5 and all(
                len(b) == 4 and -6 <= b[0] <= 7 and b[1] in time_sigs
                and labels.decode(b[2]) and labels.decode(b[3])
                for b in bars), f"(m1) {split}/{v}/{target} decodes to 5 bars")
        for midi in subs["midi"]:
            name = midi[:-4]
            check(f"{name}.pkl" in subs["target"],
                  f"(m1) {split}/{v}/{midi} has its target")
            wavs = [w for w in subs["wav"] if w.split("~")[0] == name]
            check(len(wavs) == (3 if split == "test" else 1),
                  f"(m1) {split}/{v}/{name}'s WAVs {wavs}")
            for w in wavs:
                npy = w[:-4] + ".npy"
                check(npy in subs["spectrogram"] and npy in subs["audio"],
                      f"(m1) {split}/{v}/{w} has its spectrogram and audio")
                audio = np.load(os.path.join(corpus, split, str(v), "audio",
                                             npy))
                check(audio.dtype == np.int16 and 0 < len(audio)
                      <= CLIP_SAMPLES, f"(m1) {w}'s int16 audio")
            clips += len(wavs)
        check(len(subs["wav"]) == len(subs["spectrogram"])
              == len(subs["audio"]), f"(m1) {split}/{v}: a spectrogram and "
                                     f"an audio file per WAV")
    check(all(files[s, v]["wav"] for s in ("train", "valid", "test")
              for v in versions[:1]), "(m1) clips in version 0 of every "
                                      "split")
    stage_s = {}
    for key, calls in spy.calls.items():
        for _, secs, probe in calls:
            stage_s[probe if key.endswith("_pool_map")
                    else key.rsplit(".", 1)[1]] = secs
    print(f"(m1) {sum(len(f['midi']) for f in files.values())} MIDI files "
          f"({sum(len(f['target']) - len(f['midi']) for f in files.values())}"
          f" targets without one: the rendered performance did not fit "
          f"MIDIProcess's 4-12 s window), "
          f"{len(removed)} clips removed by clean_files, {clips} WAVs and "
          f"spectrograms; host seconds: " + ", ".join(
              f"{k} {v:.2f}" for k, v in stage_s.items())
          + f"; the command {seconds:.2f}")
    return corpus, files


def phase_prepare_features(torch, tvqt, corpus, files):
    """(m2) Every clip of the corpus through get_vqt on the card (the VQT
    kernel) against its stored host spectrogram over the clip's own
    1 + L // 160 frames: on the float32 samples the feature pass computed
    it from (the WAV resampled to 16 kHz) within TOL_SPEC, and on the
    stored int16 audio/ file (what training reads), whose rounding the
    kernel and the plain f32 version see alike. Returns the largest
    errors."""
    from piano_a2s_tpu_torch.utils.audio import (PCM16_SCALE, read_wav,
                                                 resample)
    cfg = tvqt.VQTConfig()
    kernels = tvqt.filters(cfg, "cuda")
    clips = [(os.path.join(corpus, s, str(v)), w[:-4])
             for (s, v), f in files.items() for w in f["wav"]]
    err = {k: 0.0 for k in ("kernel", "plain", "kernel_int16",
                            "plain_int16")}
    lengths = []
    for i in range(0, len(clips), N_CLIPS):
        group = clips[i:i + N_CLIPS]
        host = [np.load(os.path.join(f, "spectrogram", f"{n}.npy"))
                for f, n in group]
        f32 = []
        for f, n in group:
            data, sr = read_wav(os.path.join(f, "wav", f"{n}.wav"))
            f32.append(resample(data, sr, cfg.sample_rate))
        pcm = [np.load(os.path.join(f, "audio", f"{n}.npy")) for f, n in group]
        lengths += [len(a) for a in pcm]
        for label, audio in (("", f32), ("_int16", pcm)):
            y = torch.tensor(np.stack([
                np.pad(a.astype(np.float32) / (PCM16_SCALE if label else 1),
                       (0, CLIP_SAMPLES - len(a))) for a in audio]),
                device="cuda")
            with torch.inference_mode():
                got = tvqt.get_vqt(y, kernels, cfg).cpu().numpy()
                plain = tvqt.log_compress(tvqt.vqt_magnitude_torch(
                    y, kernels, cfg)).cpu().numpy()
            for j, (a, h) in enumerate(zip(audio, host)):
                n = 1 + len(a) // cfg.hop_length
                check(h.shape == (n, cfg.n_bins), f"(m2) stored spectrogram "
                                                  f"of {group[j][1]}")
                for key, out in (("kernel", got), ("plain", plain)):
                    err[key + label] = max(err[key + label], float(
                        np.abs(out[j, :n] - h).max()))
    print(f"(m2) {len(clips)} clips of {min(lengths)}-{max(lengths)} "
          f"samples rendered from real scores: get_vqt on the card "
          f"against the stored host spectrograms, float32 samples: kernel "
          f"{err['kernel']:.3e} (atol {TOL_SPEC}), plain f32 "
          f"{err['plain']:.3e}; the stored int16 audio: kernel "
          f"{err['kernel_int16']:.3e}, plain f32 {err['plain_int16']:.3e}")
    # The kernel's accuracy contract is (c)'s, against float64 (here the
    # host twin's spectrograms): at most F64_RATIO times plain f32's error.
    # TOL_SPEC, (k2)'s bound, is printed beside it: on these sparse spectra
    # plain f32 itself comes close to it (near-floor bins, -79 dB).
    print(f"(m2) kernel within {TOL_SPEC}: {err['kernel'] <= TOL_SPEC}; "
          f"kernel / plain f32 {err['kernel'] / err['plain']:.3f} (at most "
          f"{F64_RATIO})")
    check(err["kernel"] <= max(TOL_SPEC, F64_RATIO * err["plain"]),
          "(m2) the VQT kernel gives the host feature pass's spectrograms of "
          "rendered scores within TOL_SPEC or F64_RATIO x plain f32's error")
    check(err["kernel_int16"] <= err["plain_int16"] + TOL_SPEC,
          "(m2) on the int16 audio the kernel adds at most TOL_SPEC to the "
          "rounding's error")
    return err


def phase_prepare_train(torch, tmp, corpus, files, kernel):
    """(m3) cli.pretrain at full width for one epoch on (m1)'s corpus from
    audio (configs/pretrain.yaml: midi_syn epr, so valid and test read
    versions 0-3), with its valid and test stages; the kernel's launch
    count zeroed just before. Returns the path's launches."""
    from piano_a2s_tpu_torch.cli import pretrain
    from piano_a2s_tpu_torch.train.harness import Trainer
    from piano_a2s_tpu_torch.train.logger import FileTrainLogger

    def batches(n):
        return -(-n // M_BATCH)

    n_train = max(len(files["train", v]["audio"]) for v in range(M_VERSIONS))
    n_eval = {s: sum(len(files[s, v]["audio"]) for v in range(M_VERSIONS))
              for s in ("valid", "test")}
    out = os.path.join(tmp, "run")
    spy = Spy()
    spy.wrap(Trainer, "_bucketed", lambda t, a, k, o: (
        o["upper"].shape[-1], o["lower"].shape[-1]))
    spy.wrap(Trainer, "_eval_stage")
    spy.wrap(FileTrainLogger, "log_stats", lambda lg, a, k, o: k)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    t0 = time.monotonic()
    try:
        rc = pretrain.main([
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configs", "pretrain.yaml"),
            f"workspace={tmp}", f"feature_folder={corpus}",
            f"output_folder={out}", "number_of_epochs=1",
            "input_features=audio", f"batch_size={M_BATCH}",
            f"train_versions={M_VERSIONS}", "profile_trace_steps=0",
            "--profile", "--device", "cuda"])
    finally:
        spy.undo()
    seconds = time.monotonic() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, "(m3) pretrain's exit code")
    for _, _, stages in spy.of("FileTrainLogger.log_stats"):
        for stage, stats in stages.items():
            if stage != "stats_meta":
                check(np.isfinite(stats["loss"]), f"(m3) {stage} loss finite")
    for split, n in n_eval.items():
        records = os.listdir(os.path.join(out, "results", split))
        check(len(records) == n, f"(m3) {len(records)} {split} result "
                                 f"JSONs for {n} clips")
    with open(os.path.join(out, "profile", "step_times.json")) as f:
        steps = json.load(f)["train_step"]
    with open(os.path.join(out, "train_log.txt")) as f:
        for line in f:
            print(f"(m3) train_log: {line.rstrip()}")
    expected = batches(n_train) + sum(batches(n) for n in n_eval.values())
    caps = [c[2] for c in spy.of("Trainer._bucketed")]
    print(f"(m3) one epoch of cli.pretrain on the corpus from audio: "
          f"{n_train} train items, valid {n_eval['valid']} and test "
          f"{n_eval['test']} clips, batch {M_BATCH}; {seconds:.2f} s; "
          f"seconds per train step mean {steps['mean_s']:.3f} (min "
          f"{steps['min_s']:.3f}, max {steps['max_s']:.3f}, over "
          f"{steps['count']}); eval stages " + ", ".join(
              f"{s:.3f}" for _, s, _ in spy.of("Trainer._eval_stage"))
          + f" s; bucketed caps (upper, lower) {caps} (full caps (398, "
          f"189)); peak device memory {peak / 2**30:.2f} GiB; vqt kernel "
          f"launches {launches} (expected {expected}: one per train and "
          f"eval batch)")
    check(len(caps) == batches(n_train), "(m3) train batches")
    check(launches == expected, "(m3) one vqt launch per train and eval "
          "batch")
    return launches


def phase_prepare(torch, tvqt, kernel):
    """(m) The score-to-corpus path at full width: (m1) the corpus on the
    host, (m2) its spectrograms against the VQT kernel, (m3) one epoch on
    the card (the path, with its own launch count). Returns the path's
    launches."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="prepare_") as tmp:
        corpus, files = phase_prepare_corpus(tmp)
        phase_prepare_features(torch, tvqt, corpus, files)
        return phase_prepare_train(torch, tmp, corpus, files, kernel)


def greedy_outputs(torch, tr, audio, decode_chunk):
    """``tr``'s frontend and greedy forward on a prepared batch, with
    ``decode_chunk``; decode_one's outputs (the log-probs, tokens and
    lengths) on the CPU."""
    with torch.inference_mode():
        ts, key, up, low, aux = tr.model(
            tr._frontend(audio), decode_dtype=tr.decode_dtype,
            decode_chunk=decode_chunk)
    return {k: v.cpu() for k, v in (
        ("ts", ts), ("key", key), ("up", up), ("low", low),
        ("up_tok", aux["upper_tokens"]), ("low_tok", aux["lower_tokens"]),
        ("up_len", aux["upper_lengths"]), ("low_len", aux["lower_lengths"]))}


def decode_extents(out, rows):
    """The steps each clip of ``rows`` ran, by staff: (clips, bars) counts
    of its log-prob rows that are not all zero (a stop group's buffers
    are zero after its stop)."""
    return {staff: (out[staff][rows].abs().sum(-1) > 0).sum(-1)
            for staff in ("up", "low")}


def check_stop_groups(torch, tr, audio, cfg, tol_logp, tol_margin, label):
    """(o1) ``tr``'s decode of the prepared batch ``audio`` at decode_chunk
    "auto" against each stop group's clips decoded alone (one group).

    The gate of the stop groups: every clip ran the same steps at every
    bar and staff as alone (before the bar of a first token divergence in
    its group, where the group's stop may move with it), so each group
    stopped on its own. Its control: the one-group decode of the whole
    batch (decode_chunk None) runs each group to the slowest group's step
    and must fail that gate, on the bars it covers, in at least one
    group. Per clip, a token
    divergence may only fall where the lone decode's top-2 margin is below
    ``tol_margin`` (None: below twice the group's largest log-prob
    difference, the most by which two entries can move apart); a group
    without one must give equal tokens, lengths and signatures outright.
    Log-probs up to a divergence within ``tol_logp`` (None: a reading
    only). Returns the steps each group ran, by (staff, bar)."""
    from piano_a2s_tpu_torch.models.score_transcription import \
        pick_decode_chunk
    chunk = pick_decode_chunk("auto", len(audio), tr.decode_dtype)
    check(chunk is not None and chunk < len(audio),
          f"{label} {len(audio)} clips decode in stop groups")
    out = greedy_outputs(torch, tr, audio, "auto")
    one = greedy_outputs(torch, tr, audio, None)
    groups = len(audio) // chunk
    steps = {(staff, bar): [int((out[staff][g * chunk, bar].abs().sum(-1)
                                 > 0).sum()) for g in range(groups)]
             for staff in ("up", "low") for bar in range(cfg.max_bars)}
    control = []
    for g in range(groups):
        rows = slice(g * chunk, (g + 1) * chunk)
        alone = greedy_outputs(torch, tr, audio[rows], "auto")
        mine = {k: v[rows] for k, v in out.items()}
        diffs = [decode_diff(alone, mine, cfg, i) for i in range(chunk)]
        worst = max(d[1] for d in diffs)
        near = [(i, d[2], d[3]) for i, d in enumerate(diffs)
                if d[2] is not None]
        bars = min([where[0] for _, where, _ in near] + [cfg.max_bars])
        lone = decode_extents(alone, slice(None))
        got = decode_extents(mine, slice(None))
        by_one = decode_extents(one, rows)
        control.append([b for b in range(cfg.max_bars)
                        if any(not torch.equal(by_one[st][:, b],
                                               lone[st][:, b])
                               for st in lone)])
        same_steps = all(torch.equal(got[st][:, :bars], lone[st][:, :bars])
                         for st in lone)
        gap = (mine["up"] - alone["up"]).abs().flatten()
        margin_tol = 2 * worst if tol_margin is None else tol_margin
        gate = "a reading" if tol_logp is None else f"atol {tol_logp}"
        gated = f"bars 0-{bars - 1}" if bars else "no bar"
        print(f"{label} group {g} (clips {rows.start}-{rows.stop - 1}) "
              f"against its clips alone: max|difference| log-prob "
              f"{worst:.3e} ({gate}; the upper staff's largest "
              f"{float(gap.max()):.3e} at a log-prob of "
              f"{float(alone['up'].flatten()[gap.argmax()]):.3f}); "
              f"divergences (clip, (bar, staff, step), top-2 margin; "
              f"tolerance {margin_tol:.3e}): {near or 'none'}; steps "
              f"equal to alone over {gated}: {same_steps}; the one-group "
              f"decode's steps differ in bars {control[-1] or 'none'}")
        control[-1] = any(b < bars for b in control[-1])
        if tol_logp is not None:
            check(worst < tol_logp, f"{label} group {g} log-probs agree")
        check(same_steps,
              f"{label} group {g} ran the steps its clips run alone")
        for i, where, margin in near:
            check(margin < margin_tol, f"{label} group {g} clip {i} "
                  f"diverges at {where} only at a near-tie")
        if not near:
            check(all(torch.equal(alone[k], mine[k]) for k in
                      ("up_tok", "low_tok", "up_len", "low_len"))
                  and all(torch.equal(alone[k].argmax(-1),
                                      mine[k].argmax(-1))
                          for k in ("ts", "key")),
                  f"{label} group {g}: tokens, lengths and signatures "
                  "equal outright")
    print(f"{label} steps each stop group of {chunk} ran, by (staff, bar): "
          + "; ".join(f"{staff} bar {bar} {v}"
                      for (staff, bar), v in steps.items()))
    check(any(control), f"{label} control: the one-group decode fails the "
          f"stop-step gate in some group ({sum(control)} of {groups})")
    print(f"{label} control: the one-group decode fails the stop-step gate "
          f"in {sum(control)} of {groups} groups")
    return steps


def stop_group_clips(memorized_audio):
    """(o1)'s O_CLIPS clips, four runs of 16: (k)'s memorized clips tiled;
    8 memorized clips and 8 noise of std 0.1; noise of std 0.1; noise of
    std 0.01. The memorized clips end their bars later than noise, so the
    f32 groups (the runs) and the bf16 groups (the halves) stop apart."""
    mem = list(memorized_audio)

    def tiled(n):
        return [mem[i % len(mem)] for i in range(n)]

    def noisy(n, amp, seed):
        return [noise((CLIP_SAMPLES,), amp, seed + i) for i in range(n)]

    return (tiled(16) + tiled(8) + noisy(8, 0.1, 420) + noisy(16, 0.1, 400)
            + noisy(16, 0.01, 440))


def phase_stop_groups(torch, Transcriber, state_dict, cfg, memorized_audio,
                      kernel):
    """(o1) The decode's stop groups at full width with (k3)'s weights on
    O_CLIPS clips: the path, transcribe_batch of the 64 clips at the
    default decode_chunk "auto" in f32 (4 groups of 16) and bf16 (2 of 32),
    one kernel launch a call (its count zeroed just before); each group
    against its clips alone (``check_stop_groups``), f32 groups stopping
    at different steps; then clips/s of "auto" and None in turns, and how
    many clips differ between the two. Returns the path's launches."""
    clips = stop_group_clips(memorized_audio)
    f32 = Transcriber(state_dict, cfg, device="cuda")
    bf16 = Transcriber(state_dict, cfg, device="cuda",
                       decode_dtype=torch.bfloat16)
    check(f32.decode_chunk == "auto", "(o1) the Transcriber's default")
    audio, n = f32.prepare_batch(clips)
    check(n == len(audio) == O_CLIPS, "(o1) a batch of 64, no padding")
    for tr in (f32, bf16):
        tr.transcribe_batch(clips)  # first call at this shape
    kernel.launches = 0
    results = {"f32": f32.transcribe_batch(clips),
               "bf16": bf16.transcribe_batch(clips)}
    launches = kernel.launches
    print(f"(o1) transcribe_batch of {O_CLIPS} clips in f32 and bf16: vqt "
          f"kernel launches {launches}")
    check(launches == 2, "(o1) one vqt launch a batch")
    for name, res in results.items():
        check_results(res, cfg, f"(o1) {name}", O_CLIPS)
    steps = check_stop_groups(torch, f32, audio, cfg, TOL_LOGP, TOL_MARGIN,
                              "(o1) f32")
    check(any(len(set(v)) > 1 for v in steps.values()),
          "(o1) the f32 stop groups stop at different steps")
    check_stop_groups(torch, bf16, audio, cfg, None, None, "(o1) bf16")
    one = Transcriber(state_dict, cfg, device="cuda", decode_chunk=None)
    one.transcribe_batch(clips)  # first call at this shape
    turns, outs = {"auto": [], "None": []}, {}
    for name, tr in (("auto", f32), ("None", one), ("None", one),
                     ("auto", f32)):
        t0 = time.monotonic()
        outs[name] = tr.transcribe_batch(clips)
        turns[name].append(time.monotonic() - t0)
    rate = {k: O_CLIPS / float(np.median(v)) for k, v in turns.items()}
    differ = sum(a != b for a, b in zip(outs["auto"], outs["None"]))
    print(f"(o1) f32 transcribe_batch of {O_CLIPS} clips in turns auto, "
          f"None, None, auto: "
          + ", ".join(f"{k} {[round(t, 3) for t in v]} s ({rate[k]:.2f} "
                      f"clips/s)" for k, v in turns.items())
          + f"; auto / None {rate['auto'] / rate['None']:.3f}; clips whose "
          f"results differ between the two: {differ} of {O_CLIPS}")
    return launches


def phase_export(tmodels, tstep, load_transcriber, state_dict,
                 memorized_audio, tmp):
    """(o2) (k3)'s weights in a save folder (as (n) saves them), through
    cli.export_checkpoint, then cli.import_checkpoint, then
    load_transcriber, with and without --modulelist: the weights bit-equal
    to the save folder's (num_batches_tracked aside: the export writes 0)
    and the tokens of (k)'s clips equal."""
    from piano_a2s_tpu_torch.cli import export_checkpoint, import_checkpoint
    config = os.path.join(REPO_DIR, "configs", "pretrain.yaml")
    save = save_folder_of(tmodels, tstep, state_dict,
                          os.path.join(tmp, "save"))
    ref = load_transcriber(save, device="cuda")
    want = ref.transcribe_batch(memorized_audio)
    weights = {k: v for k, v in ref.model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    for flags in ([], ["--modulelist"]):
        name = "".join(flags) or "bare"
        out = os.path.join(tmp, f"export{name}")
        again = os.path.join(tmp, f"import{name}")
        t0 = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            check(export_checkpoint.main([save, "--config", config, "--out",
                                          out] + flags) == 0,
                  f"(o2) export {name}")
            check(import_checkpoint.main([out, "--config", config, "--out",
                                          again]) == 0, f"(o2) import {name}")
        seconds = time.monotonic() - t0
        tr = load_transcriber(again, device="cuda")
        got = tr.model.state_dict()
        equal = sum(int(same_state({k: got[k]}, {k: v}))
                    for k, v in weights.items())
        same = tr.transcribe_batch(memorized_audio) == want
        print(f"(o2) export ({name}) then import in {seconds:.2f} host s, "
              f"{os.path.getsize(os.path.join(out, 'model.ckpt'))} bytes: "
              f"{equal}/{len(weights)} tensors bit-equal; tokens of "
              f"{len(memorized_audio)} clips equal {same}; the commands "
              f"printed {len(text.getvalue().splitlines())} lines")
        check(equal == len(weights), f"(o2) {name}: weights bit-equal")
        check(same, f"(o2) {name}: the same tokens")


def phase_entry(torch, Transcriber, tmodels):
    """(o3) entry() on the card: the output shapes, the seconds of its
    set-up and of one forward, and its tokens and signatures equal to
    Transcriber._infer_spectrogram's on the same weights and
    spectrogram; then ``python -m piano_a2s_tpu_torch.entry multichip 2``
    (two ranks sharing the card) must exit 0."""
    from piano_a2s_tpu_torch.entry import entry
    cfg = tmodels.ModelConfig()
    t0 = time.monotonic()
    fn, args = entry()
    setup_s = time.monotonic() - t0
    runs = []
    for _ in range(2):
        t0 = time.monotonic()
        with torch.inference_mode():
            outs = fn(*args)
        torch.cuda.synchronize()
        runs.append(time.monotonic() - t0)
    shapes = [tuple(x.shape) for x in outs]
    print(f"(o3) entry(): set-up {setup_s:.2f} s, forward {runs[0]:.2f} s "
          f"then {runs[1]:.2f} s; outputs {shapes}")
    check(shapes == [(1, 5, 7), (1, 5, 14), (1, 5, 398), (1, 5, 189)],
          "(o3) entry's output shapes")
    tr = Transcriber(tmodels.init_state_dict(cfg, 0), cfg, device="cuda")
    ts, key, up, low, _, _ = tr._infer_spectrogram(args[1])
    check(torch.equal(outs[0].argmax(-1).to(torch.uint8), ts)
          and torch.equal(outs[1].argmax(-1).to(torch.uint8), key)
          and torch.equal(outs[2].to(torch.uint8), up)
          and torch.equal(outs[3].to(torch.uint8), low),
          "(o3) entry's tokens equal Transcriber._infer_spectrogram's")
    # The multi-rank dry run, as a user starts it: two gloo ranks sharing
    # the card, each through the tiny train steps (f32, bf16, from audio
    # with the kernel, guided attention) and the eval step.
    t0 = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "piano_a2s_tpu_torch.entry", "multichip",
         "2"], capture_output=True, text=True, timeout=DP_TIMEOUT_S,
        cwd=REPO_DIR)
    if run.returncode != 0:
        print(run.stdout[-4000:] + run.stderr[-4000:])
    print(f"(o3) entry multichip 2 on the card: exit {run.returncode} in "
          f"{time.monotonic() - t0:.1f} s; {run.stdout.strip()[-200:]}")
    check(run.returncode == 0
          and "dryrun_multichip(2) on cuda OK" in run.stdout,
          "(o3) the two-rank dry run on the card")


def phase_uneven_dp(torch, tmodels, tstep, tvqt):
    """(o4) The data-parallel step on a batch whose microbatches do not
    split over the ranks: ``uneven_batch`` (B = TRAIN_CLIPS) at A =
    O_ACCUM, one row a microbatch, on two gloo ranks on cuda:0 (rank 0
    owns no row and computes stand-in rows that weigh 0 and count in no
    BatchNorm statistic; row 0 weighs 0), against the plain
    train_step_accum (world size 1) within TOL_DP_RANKS, the ranks
    identical. Returns the ranks' kernel launches (one a microbatch)."""
    from piano_a2s_tpu_torch import parallel
    cfg, model, before, optimizer, opts = full_width_training(
        tmodels, tstep, tvqt)
    t_plain, _ = tstep.make_train_steps(optimizer, accum_steps=O_ACCUM,
                                        **opts)
    t0 = time.monotonic()
    ref = t_plain(model, uneven_batch(cfg),
                  torch.Generator("cuda").manual_seed(0), 0.7)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    ref_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    layout = [parallel.step_rows(r, 2, TRAIN_CLIPS, O_ACCUM)
              for r in range(2)]
    print(f"(o4) B={TRAIN_CLIPS}, A={O_ACCUM}, N=2: each rank's rows, "
          f"offset in a microbatch and whether it owns them "
          f"{[(rows.tolist(), start, owned) for rows, start, owned in layout]}"
          f"; the plain step {plain_s:.3f} s, loss {float(ref.loss):.6f}")
    check(not all(owned for _, _, owned in layout),
          "(o4) one rank owns no row")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    results = run_dp_ranks(torch, "gloo", ["cuda:0"] * 2, ref_state,
                           float(ref.loss), before, O_ACCUM, "o4")
    print(f"(o4) 2 ranks over gloo on cuda:0: {time.monotonic() - t0:.1f} s "
          f"with start-up")
    return sum(r["launches"] for r in results)


def main():
    t_main = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import piano_a2s_tpu_torch.models as tmodels
    import piano_a2s_tpu_torch.ops.layers as tlayers
    import piano_a2s_tpu_torch.train.step as tstep
    from piano_a2s_tpu_torch.infer import Transcriber, load_transcriber
    from piano_a2s_tpu_torch.models import ModelConfig, init_state_dict
    from piano_a2s_tpu_torch.ops import _build
    from piano_a2s_tpu_torch.ops import vqt as tvqt
    from piano_a2s_tpu_torch.ops.vqt_cuda import vqt_magnitude_cuda
    from piano_a2s_tpu_torch.serve import make_server

    # (a) device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"(a) python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # (b) build
    build = _build.build("vqt_mag")
    print(f"(b) built {build.path} in {build.seconds:.2f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"(b) ptxas: {line.strip()}")

    # (c) kernel vs plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    max_err, err_f64, plain_err_f64, ms, plain_ms = phase_kernel_vs_plain(
        torch, tvqt, lambda: vqt_magnitude_cuda.launches)

    # (d) full width, GPU vs CPU
    cfg = ModelConfig()
    state_dict = init_state_dict(cfg, seed=0)
    gpu = Transcriber(state_dict, cfg, device="cuda")
    cpu = Transcriber(state_dict, cfg, device="cpu")
    phase_gpu_vs_cpu(torch, cfg, tvqt, gpu, cpu)
    del cpu

    clips = [noise((CLIP_SAMPLES,), 0.1, 100 + i) for i in range(N_CLIPS)]
    gpu.transcribe_batch(clips)  # first call at this shape
    stages = stage_seconds(torch, tvqt, gpu, clips)
    print(f"(e) stage seconds at batch {N_CLIPS}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))

    # The serving path, (e) + (f), with the launch counts zeroed first.
    vqt_magnitude_cuda.launches = 0
    t0 = time.monotonic()
    results = gpu.transcribe_batch(clips)
    e_seconds = time.monotonic() - t0
    check_results(results, cfg, "(e)")
    after_batch = vqt_magnitude_cuda.launches
    print(f"(e) transcribe_batch of {N_CLIPS} x 12 s clips: {e_seconds:.3f} "
          f"s, {N_CLIPS / e_seconds:.2f} clips/s; vqt kernel launches "
          f"{after_batch}")
    check(after_batch > 0, "the batch went through the vqt kernel")
    phase_server(make_server, gpu)
    after_server = vqt_magnitude_cuda.launches
    print(f"(f) vqt kernel launches over (e) and (f): {after_server}")
    check(after_server > after_batch, "the server went through the vqt "
          "kernel")
    launches = {"serve": after_server}
    del gpu

    # (g) training; (g2) is the training path, with the counts zeroed first.
    phase_train_f64(torch, tmodels, tstep, tlayers)
    gc.collect()  # (g2)'s and (i2)'s peaks start from what is still live
    vqt_magnitude_cuda.launches = 0
    _, f32_peak = phase_train_full(torch, tmodels, tstep, tvqt,
                                   lambda: vqt_magnitude_cuda.launches)
    launches["train"] = vqt_magnitude_cuda.launches
    print(f"(g2) vqt kernel launches over (g2): {launches['train']}")
    check(launches["train"] == TRAIN_STEPS + 2,
          "the training path went through the vqt kernel")
    t_h = time.monotonic()
    seconds_a_to_g = t_h - t_main

    # (h) the training harness, with its own launch count.
    vqt_magnitude_cuda.launches = 0
    expected = phase_trainer(torch)
    launches["trainer"] = vqt_magnitude_cuda.launches
    print(f"(h) vqt kernel launches over (h): {launches['trainer']} "
          f"(expected {expected}); phases (a)-(g) took "
          f"{seconds_a_to_g:.1f} s, (h) {time.monotonic() - t_h:.1f} s")
    check(launches["trainer"] == expected,
          "the harness path launched the vqt kernel once per train batch, "
          "eval batch and transcribe call")

    # (i) the bf16 paths, each with its own launch count: serving (i1),
    # zeroed inside it just before its path; training (i2).
    t_i = time.monotonic()
    launches["serve_bf16"] = phase_serve_bf16(
        torch, tvqt, Transcriber, make_server, state_dict, cfg, clips,
        e_seconds, vqt_magnitude_cuda)
    print(f"(i1) vqt kernel launches over the bf16 serving path: "
          f"{launches['serve_bf16']}")
    gc.collect()
    vqt_magnitude_cuda.launches = 0
    phase_train_bf16(torch, tmodels, tstep, tvqt,
                     lambda: vqt_magnitude_cuda.launches, f32_peak)
    launches["train_bf16"] = vqt_magnitude_cuda.launches
    print(f"(i2) vqt kernel launches over (i2): {launches['train_bf16']}; "
          f"(i) took {time.monotonic() - t_i:.1f} s")
    check(launches["train_bf16"] == BF16_TRAIN_STEPS,
          "the bf16 training path went through the vqt kernel")

    # (j) the multi-device paths, each zeroing the counts just before its
    # path: mesh serving (j1), data-parallel training (j2).
    t_j = time.monotonic()
    launches["serve_mesh"] = phase_serve_mesh(
        torch, Transcriber, state_dict, cfg, clips, results,
        vqt_magnitude_cuda)
    gc.collect()
    launches["train_dp"] = phase_train_dp(torch, tmodels, tstep, tvqt,
                                          vqt_magnitude_cuda)
    print(f"(j2) vqt kernel launches over (j2): {launches['train_dp']}; "
          f"(j) took {time.monotonic() - t_j:.1f} s")

    # (k) the synth path, zeroing the counts just before (k3); (l) the
    # evaluation path on (k)'s test split with (k3)'s weights, zeroing them
    # just before the test stage; (n) the diagnostic tools on the same
    # corpus and weights, each zeroing them just before its path.
    import tempfile
    gc.collect()
    with tempfile.TemporaryDirectory(prefix="synth_corpus_") as corpus:
        t_k = time.monotonic()
        launches["synth"], memorized_state = phase_synth(
            torch, tmodels, tstep, tvqt, Transcriber, state_dict,
            vqt_magnitude_cuda, corpus)
        print(f"(k) took {time.monotonic() - t_k:.1f} s")
        t_l = time.monotonic()
        launches["evaluate"] = phase_evaluate(torch, corpus, memorized_state,
                                              vqt_magnitude_cuda)
        print(f"(l) took {time.monotonic() - t_l:.1f} s")
        t_n = time.monotonic()
        launches.update(phase_diagnostics(
            tmodels, tstep, load_transcriber, make_server, corpus,
            memorized_state, vqt_magnitude_cuda))
        print(f"(n) took {time.monotonic() - t_n:.1f} s")

        # (o) the port's last gaps: (o1) the stop groups, the path
        # serve_chunked, zeroing the counts just before it; (o2) the
        # export round trip, on (k)'s clips and (k3)'s weights.
        t_o = time.monotonic()
        audio_dir = os.path.join(corpus, "test", "0", "audio")
        memorized_audio = [np.load(os.path.join(audio_dir, f))
                           for f in sorted(os.listdir(audio_dir))]
        launches["serve_chunked"] = phase_stop_groups(
            torch, Transcriber, memorized_state, ModelConfig(),
            memorized_audio, vqt_magnitude_cuda)
        print(f"(o1) took {time.monotonic() - t_o:.1f} s")
        t_o2 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="export_") as tmp:
            phase_export(tmodels, tstep, load_transcriber, memorized_state,
                         memorized_audio, tmp)
        print(f"(o2) took {time.monotonic() - t_o2:.1f} s")

    # (o3) entry() on the card; (o4) the data-parallel step whose
    # microbatches do not split over the ranks, its ranks' launches added
    # to the data-parallel path's.
    t_o3 = time.monotonic()
    phase_entry(torch, Transcriber, tmodels)
    print(f"(o3) took {time.monotonic() - t_o3:.1f} s")
    gc.collect()
    t_o4 = time.monotonic()
    uneven = phase_uneven_dp(torch, tmodels, tstep, tvqt)
    launches["train_dp"] += uneven
    print(f"(o4) vqt kernel launches over the ranks: {uneven}; (o4) took "
          f"{time.monotonic() - t_o4:.1f} s; (o) took "
          f"{time.monotonic() - t_o:.1f} s")

    # (m) the score-to-corpus path: the corpus (m1) and its spectrograms
    # against the kernel (m2), then one epoch (m3), the path, zeroing the
    # counts just before it.
    gc.collect()
    t_m = time.monotonic()
    launches["prepare"] = phase_prepare(torch, tvqt, vqt_magnitude_cuda)
    print(f"(m) took {time.monotonic() - t_m:.1f} s")
    check("jax" not in sys.modules, "no jax imported")
    check(not any(m == "piano_a2s_tpu" or m.startswith("piano_a2s_tpu.")
                  for m in sys.modules), "nothing of the JAX package imported")

    check(len(launches) == 14 and min(launches.values()) > 0,
          f"every one of the 14 paths launched the vqt kernel: {launches}")
    bound_ms, bound_by = vqt_bound(N_CLIPS, CLIP_SAMPLES)
    print(f"chip_smoke: every phase passed in {time.monotonic() - t_main:.1f}"
          f" s")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "vqt_mag", "route": "cuda",
        "source": "piano_a2s_tpu_torch/csrc/vqt_mag.cu",
        "replaces": "piano_a2s_tpu/ops/vqt_pallas.py:31",
        "design": "split-TF32 (3xTF32) wgmma m64n160k8 fed by TMA, 128 x "
                  "160 tile, 3 stages, 32-tap chunk sums; pad/split pre-pass",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": max_err, "err_f64": err_f64,
        "plain_err_f64": plain_err_f64, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-dp-rank"]:
        sys.exit(train_dp_rank(sys.argv[2:]))
    sys.exit(main())
