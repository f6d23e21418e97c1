"""Offline serving: one caller, batches back to back through
``Transcriber.transcribe_batch`` (a closed loop).

Set-up makes the weights from the seed on the device, builds the
Transcriber, makes the mix's pool of batches and runs one batch (the
shapes of the window, so that the kernel build, cuDNN's and cuBLAS's
first calls are set-up). The window calls batch after batch until
``seconds`` have passed; a traced run profiles its first ``profile_units``
batches. Then a sample of the finished batches, drawn from the seed, is
run through the reference and judged (``judge.served_readings``), and what
every batch's call returned is held to what its decoder served.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from ..harness import judge, traffic as T
from ..harness.record import LayerSpans, Run
from ..harness.reference import Reference
from ..harness.trace import profiled
from ..harness.weights import seeded_weights


def build(run: Run):
    """The Transcriber of the run's configuration on the run's seed, with
    the benchmark's spans around its layers; the decoder's span keeps a
    reference to each call's outputs (log-probs, tokens, lengths)."""
    from piano_a2s_tpu_torch.infer import Transcriber
    from piano_a2s_tpu_torch.models.score_transcription import ModelConfig
    from piano_a2s_tpu_torch.ops.vqt import VQTConfig

    cfg, mix = run.cell.config, run.cell.traffic
    m = cfg["model"]
    weights = seeded_weights(m, run.seed, run.device, mix.get("eos_bias"))
    tr = Transcriber(weights, ModelConfig(**dict(
        m, max_length=tuple(m["max_length"]))), VQTConfig(**cfg["vqt"]),
        max_frame_num=cfg["frames"], device=run.device,
        decode_dtype=None, decode_chunk=cfg["decode_chunk"])
    del weights
    spans = LayerSpans()
    decoded = {}

    def keep(out):
        decoded["last"] = out

    spans.wrap(tr.model.convstack, "forward/convstack")
    spans.wrap(tr.model.encoder, "forward/encoder")
    spans.wrap(tr.model.decoder, "forward/decoder", keep)
    return tr, spans, decoded


def logp_host(out) -> dict:
    """The decode's log-probs (time_sig, key, upper, lower) on the host."""
    return {k: v.float().cpu() for k, v in
            zip(("time_sig", "key", "upper", "lower"), out)}


def served_arrays(out) -> dict:
    """What the decoder served, on the host: the signatures' classes, each
    staff's tokens (B, bars, cap) and lengths (B, bars)."""
    ts, key, _, _, aux = out
    host = {k: v.cpu().numpy().astype(np.int64) for k, v in aux.items()}
    return {"time_sig": ts.argmax(-1).cpu().numpy(),
            "key": key.argmax(-1).cpu().numpy(),
            "upper": host["upper_tokens"], "lower": host["lower_tokens"],
            "upper_len": host["upper_lengths"],
            "lower_len": host["lower_lengths"]}


def returned_mismatch(returned: list, served: dict, time_sigs: list,
                      eos: int) -> int:
    """Clips and bars where what ``transcribe_batch`` returned differs from
    what the decoder served: [key - 6, time signature, lower tokens, upper
    tokens], each staff's tokens cut at their first <eos>."""
    def cut(row):
        row = list(row)
        return row[:row.index(eos)] if eos in row else row

    rows = served["upper"].shape[0]
    bad = abs(len(returned) - rows)
    for b, bars in enumerate(returned[:rows]):
        for j, bar in enumerate(bars):
            want = [int(served["key"][b, j]) - 6,
                    time_sigs[int(served["time_sig"][b, j])],
                    cut(served["lower"][b, j]), cut(served["upper"][b, j])]
            bad += bar != want
    return bad


def run(run: Run) -> None:
    import torch

    t0 = time.perf_counter()
    cfg, mix = run.cell.config, run.cell.traffic
    sr = cfg["vqt"]["sample_rate"]
    b = mix["batch"]
    tr, spans, decoded = build(run)
    pool = [T.clips(mix, run.seed, i * b, b, sr) for i in range(mix["pool"])]
    tr.transcribe_batch(pool[0])
    if run.device != "cpu":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t0

    n_prof = mix.get("profile_units", 2) if run.traced else 0
    # The batches whose log-probs are kept for the check: drawn from the
    # seed among the first few, which every window finishes.
    keep = set(T.rng(run.seed, T.STREAM_SAMPLE).choice(
        mix.get("sample_from", 4), run.cell.limits.get("sample_units", 1),
        replace=False).tolist())

    def one(i: int, profiled_unit: bool) -> dict:
        before = spans.snapshot()
        u0 = time.perf_counter()
        returned = tr.transcribe_batch(pool[i % len(pool)])
        u1 = time.perf_counter()
        after = spans.snapshot()
        out = decoded.pop("last")
        unit = {"index": i, "clips": b, "t0": u0, "t1": u1,
                "profiled": profiled_unit, "returned": returned,
                "decoded": out[:2] + (None, None) + out[4:],
                "layers": {k: after[k] - before.get(k, 0.0) for k in after}}
        if i in keep:
            unit["logp"] = out[:4]
        return unit

    w0 = time.perf_counter()
    if n_prof:
        units, run.trace, _ = profiled(
            lambda: [one(i, True) for i in range(n_prof)])
        run.units.extend(units)
    i = n_prof
    while time.perf_counter() - w0 < run.seconds:
        run.units.append(one(i, False))
        i += 1
    run.window_s = run.units[-1]["t1"] - w0
    # A kept batch the window did not reach runs after it closes, outside
    # the window's numbers (a short calibration window).
    late = []
    while i <= max(keep):
        late.append(one(i, False))
        i += 1
    run.extra["late_units"] = late
    run.attempted = sum(u["clips"] for u in run.units)
    run.failed = 0
    if run.device != "cpu":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    model_cfg = cfg["model"]
    mismatch = 0
    for u in run.units + late:
        u["served"] = served_arrays(u.pop("decoded"))
        u["stops"] = stops_of(u["served"], model_cfg, cfg["decode_chunk"])
        mismatch += returned_mismatch(u.pop("returned"), u["served"],
                                      tr.time_sig_list, model_cfg["eos"])
        if "logp" in u:
            u["logp"] = logp_host(u["logp"])
    run.extra["returned_mismatch"] = mismatch
    run.extra["group"] = judge.pick_group(cfg["decode_chunk"], b)
    run.extra["audio_of"] = lambda u: pool[u["index"] % len(pool)]
    del tr, decoded
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()
    check(run, run.extra["audio_of"])


def stops_of(served: dict, model: dict, decode_chunk) -> np.ndarray:
    """(bars, 2, groups) steps each stop group of each staff ran."""
    group = judge.pick_group(decode_chunk, served["upper"].shape[0])
    per = [judge.stop_structure(served[s], served[f"{s}_len"], model["eos"],
                                group)[0] for s in ("upper", "lower")]
    return np.stack(per, axis=1)


def pick(run: Run):
    """The finished units whose log-probs were kept (drawn from the seed
    before the window)."""
    return [u for u in run.units + run.extra["late_units"] if "logp" in u]


def check(run: Run, audio_of) -> None:
    """Judge a sample of the finished batches against the reference."""
    cfg, mix = run.cell.config, run.cell.traffic
    m = cfg["model"]
    ref = Reference(seeded_weights(m, run.seed, run.device,
                                   mix.get("eos_bias")),
                    m, cfg["vqt"], cfg["frames"], "f64", run.device)
    worst = {"gap": 0.0, "logp_err": 0.0, "stop_mismatch": 0, "judged": 0}
    t0 = time.perf_counter()
    run.extra["judged_units"] = []
    for u in pick(run):
        audio = _audio_tensor(np.stack(audio_of(u)))
        if u["served"]["upper"].shape[0] != audio.shape[0]:
            continue            # counted by returned_mismatch
        served = judge.served_lengths(u["served"], m, cfg["decode_chunk"])
        out = ref.judge_served(audio, _tensors(served))
        run.extra["judged_units"].append((audio, served, out))
        r = judge.served_readings(out, served, m, cfg["decode_chunk"],
                                  u["logp"])
        worst = {"gap": max(worst["gap"], r["gap"]),
                 "logp_err": max(worst["logp_err"], r["logp_err"]),
                 "stop_mismatch": worst["stop_mismatch"] + r["stop_mismatch"],
                 "judged": worst["judged"] + r["judged"]}
    run.extra["check_s"] = time.perf_counter() - t0
    lim = run.cell.limits
    run.check("token_gap", worst["gap"], lim["token_gap"])
    run.check("logp_err", worst["logp_err"], lim["logp_err"])
    run.check("stop_mismatch", worst["stop_mismatch"], 0)
    run.check("returned_mismatch", run.extra["returned_mismatch"], 0)
    run.check("judged_positions", worst["judged"], 1, upper=False)


def control(run: Run) -> dict:
    """The control's readings on the batches ``check`` judged: the
    reference in TF32 put in the program's place (judge.control_readings).
    Not part of a benchmark run: bench_port/calibrate.py runs it."""
    cfg, mix = run.cell.config, run.cell.traffic
    m = cfg["model"]
    ctl = Reference(seeded_weights(m, run.seed, run.device,
                                   mix.get("eos_bias")),
                    m, cfg["vqt"], cfg["frames"], "tf32", run.device)
    worst: dict = {}
    for audio, served, out in run.extra["judged_units"]:
        ctl_out = ctl.judge_served(audio, _tensors(served))
        r = judge.control_readings(out, ctl_out, served, m,
                                   cfg["decode_chunk"])
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in r.items()}
    return worst


def _audio_tensor(audio: np.ndarray):
    import torch

    a = torch.from_numpy(np.ascontiguousarray(audio))
    return a.double() / 32768.0 if a.dtype == torch.int16 else a.double()


def _tensors(served: dict) -> dict:
    import torch

    return {k: torch.as_tensor(np.asarray(v)) for k, v in served.items()}
