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
      scaled by 1/32768 (a training batch and microbatch of (g2)), each
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

Each main path has its own launch counts, zeroed just before it and read
just after it: serving over (e) and (f), training over (g2), the harness
over (h), which must launch the kernel exactly once per train batch, eval
batch and transcribe call, bf16 serving over (i1)'s batch and request,
bf16 training over (i2), once per step. Each path must have launched every
kernel it runs. The line before the last holds the
kernels' JSON record (``launches`` is the sum over the paths,
``launches_by_path`` each path's count); the last line is the result
object.
"""

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

    # Serving shapes, then (g2)'s batch and microbatch; 16 x 12 s last, as
    # it is timed below.
    cases = (((2, 48000), noise((2, 48000), 0.2, 0)),
             ((TRAIN_CLIPS, CLIP_SAMPLES), pcm((TRAIN_CLIPS, CLIP_SAMPLES), 5)),
             ((TRAIN_CLIPS // 2, CLIP_SAMPLES),
              pcm((TRAIN_CLIPS // 2, CLIP_SAMPLES), 6)),
             ((N_CLIPS, CLIP_SAMPLES), noise((N_CLIPS, CLIP_SAMPLES), 0.1, 1)))
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


def compare_decodes(ref, got, cfg, tol_logp, tol_margin, label):
    """Hold ``got``'s greedy decode of one clip against ``ref``'s: the
    time and key signature log-probs and each staff's log-probs within
    ``tol_logp`` up to the first token divergence, which may only fall
    where ``ref``'s top-2 log-prob margin is below ``tol_margin``; the
    bars after it are conditioned on other tokens and are not compared.
    Returns (steps compared, max |difference|, first divergence)."""
    steps, worst, diverged = 0, 0.0, None
    for bar in range(cfg.max_bars):
        if diverged is not None:
            break
        for key_name in ("ts", "key"):
            e = (got[key_name][0, bar] - ref[key_name][0, bar]).abs().max()
            worst = max(worst, e.item())
        for staff in ("up", "low"):
            gt, rt = got[f"{staff}_tok"][0, bar], ref[f"{staff}_tok"][0, bar]
            ran = int((ref[staff][0, bar].abs().sum(-1) > 0).sum())
            diff = (gt[:ran] != rt[:ran]).nonzero()
            first = int(diff[0]) if len(diff) else None
            stop = ran if first is None else first + 1
            e = (got[staff][0, bar, :stop].float()
                 - ref[staff][0, bar, :stop].float()).abs()
            worst = max(worst, e.max().item())
            steps += stop
            if first is not None:
                top2 = ref[staff][0, bar, first].topk(2).values
                margin = (top2[0] - top2[1]).item()
                print(f"{label} tokens diverge at bar {bar} staff {staff} "
                      f"step {first}: top-2 margin {margin:.3e}")
                check(margin < tol_margin, f"{label} divergence only at a "
                      "near-tie")
                diverged = (bar, staff, first)
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


def check_results(results, cfg, label):
    """The target structures of a batch of N_CLIPS clips are well-formed."""
    check(len(results) == N_CLIPS, f"{label} one result per clip")
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


def full_width_training(tmodels, tstep, tvqt):
    """(g2)'s and (i2)'s set-up: the full-width model from seed 0 on the
    card, a snapshot of its state, its optimizer and the options of a
    train step from audio with guided attention."""
    cfg = tmodels.ModelConfig()
    model = tmodels.ScoreTranscription(cfg)
    model.load_state_dict(tmodels.init_state_dict(cfg, seed=0), strict=True)
    model.to("cuda")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = tstep.make_optimizer(model.parameters())
    opts = dict(from_audio=True, vqt_cfg=tvqt.VQTConfig(),
                max_frame_num=1201, ga_weight=1.0, ga_sigma=0.15,
                ga_dur_frac=tstep.duration_fraction_table(cfg.vocab_size),
                device="cuda")
    return cfg, model, before, optimizer, opts


def train_batch(cfg, i):
    """The i-th training batch of (g2) and (i2): 4 x 12 s of int16 noise
    with random targets."""
    from piano_a2s_tpu_torch.train.synthetic import audio_batch
    return audio_batch(cfg, TRAIN_CLIPS, CLIP_SAMPLES, seed=200 + i,
                       targets_seed=300 + i)


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


class Spy:
    """Wraps methods on the training path so that each call records its
    phase, its seconds and what ``probe(obj, args, kwargs, result)`` reads;
    the methods themselves run unchanged. ``undo`` restores them."""

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


def main():
    t_main = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import piano_a2s_tpu_torch.models as tmodels
    import piano_a2s_tpu_torch.ops.layers as tlayers
    import piano_a2s_tpu_torch.train.step as tstep
    from piano_a2s_tpu_torch.infer import Transcriber
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
    check("jax" not in sys.modules, "no jax imported")
    check(not any(m == "piano_a2s_tpu" or m.startswith("piano_a2s_tpu.")
                  for m in sys.modules), "nothing of the JAX package imported")

    bound_ms, bound_by = vqt_bound(N_CLIPS, CLIP_SAMPLES)
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
    sys.exit(main())
