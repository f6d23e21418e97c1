"""Training: ``train_step``s back to back through
``train/step.py::make_train_steps(from_audio=True)``.

Set-up makes the weights from the seed on the device, builds the model,
Adadelta and the step, makes the mix's pool of batches (int16 audio,
targets at real bar lengths, cut to the bucket width) and drives the step
through its first ``anchor_steps`` batches with a generator seeded from
the run's seed: those steps warm every shape, and their losses, the
optimizer's state after the first and the parameters after the first and
the last are what the reference follows from the seed. The window then
runs step after step on the same objects; a traced run profiles its first
``profile_units`` steps. One window step, drawn from the seed among the
``sample_from`` after the first, is judged too: the model's and Adadelta's
state are copied to the host before and after it, and the reference takes
the same step from the state before (the program's: the reference cannot
follow every window step from the seed). A non-finite loss in the window
fails the run. Once the window has closed and the program is freed, the
reference repeats the anchor steps and the judged step in float64 (the
same dropout keeps and teacher-forcing coins, drawn in the step's order
from a generator seeded alike).
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np

from ..harness import judge, traffic as T
from ..harness.record import Run
from ..harness.reference import Draws, Reference
from ..harness.trace import profiled
from ..harness.weights import seed_int, seeded_weights


def step_seed(seed: int) -> int:
    """The seed of the training step's generator (not the weights')."""
    return (seed_int(seed) + 1) % (1 << 63)


def make_batches(run: Run) -> list:
    cfg, mix = run.cell.config, run.cell.traffic
    sr, b = cfg["vqt"]["sample_rate"], mix["batch"]
    lengths = T.bar_lengths(mix)
    out = []
    for i in range(mix["pool"]):
        batch = T.targets(mix, cfg["model"], run.seed, i, lengths)
        batch["audio"] = np.stack(T.clips(mix, run.seed, i * b, b, sr))
        out.append(batch)
    return out


def _named(model):
    """The parameters and the floating BatchNorm buffers."""
    return list(model.named_parameters()) + [
        (k, v) for k, v in model.named_buffers() if v.is_floating_point()]


def _state(model) -> Dict[str, "torch.Tensor"]:
    """The parameters and the floating BatchNorm buffers, cloned."""
    return {k: v.detach().clone() for k, v in _named(model)}


def _host_state(model, opt) -> dict:
    """The model's state and Adadelta's (square_avg, acc_delta) per
    parameter, copied to the host."""
    def copy(t):
        return t.detach().to("cpu", copy=True)

    state = {k: copy(v) for k, v in _named(model)}
    moments = {}
    for name, p in model.named_parameters():
        st = opt.state.get(p)
        if st:
            moments[name] = (copy(st["square_avg"]), copy(st["acc_delta"]))
    return {"state": state, "opt": moments}


def _change(before: dict, after: dict) -> Dict[str, float]:
    return {k: float((after[k].double() - before[k].double()).norm())
            for k in after}


def window_program(ws: dict, rho: float) -> dict:
    """The judged window step's readings from the program's state before
    and after it: its loss, each leaf's gradient norm as Adadelta got it
    (from square_avg = rho * square_avg + (1 - rho) * g^2) and each leaf's
    change."""
    before, after = ws["before"], ws["after"]
    grad = {}
    for k in ws["params"]:
        if k in after["opt"] and k in before["opt"]:
            g2 = (after["opt"][k][0].double()
                  - rho * before["opt"][k][0].double()).sum() / (1.0 - rho)
            grad[k] = math.sqrt(max(float(g2), 0.0))
        else:
            grad[k] = float("nan")
    return {"loss": [ws["loss"]], "grad": grad,
            "change": _change(before["state"], after["state"])}


def run(run: Run) -> None:
    import torch

    from piano_a2s_tpu_torch.models.score_transcription import (
        ModelConfig, ScoreTranscription)
    from piano_a2s_tpu_torch.ops.vqt import VQTConfig
    from piano_a2s_tpu_torch.train.step import (make_optimizer,
                                                make_train_steps)

    t0 = time.perf_counter()
    cfg, mix = run.cell.config, run.cell.traffic
    m, oc = cfg["model"], cfg["optimizer"]
    cuda = run.device != "cpu"
    model = ScoreTranscription(ModelConfig(**dict(
        m, max_length=tuple(m["max_length"]))))
    model.load_state_dict(seeded_weights(m, run.seed, run.device),
                          strict=True)
    model.to(run.device)
    opt = make_optimizer(model.parameters(), lr=oc["lr"], rho=oc["rho"],
                         eps=oc["eps"])
    step, _ = make_train_steps(opt, from_audio=True,
                               vqt_cfg=VQTConfig(**cfg["vqt"]),
                               max_frame_num=cfg["frames"],
                               device=run.device)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(step_seed(run.seed))
    batches = make_batches(run)
    tf = cfg["tf_ratio"]

    before = _state(model)
    losses, first_grads, change1 = [], {}, {}
    for k in range(mix["anchor_steps"]):
        out = step(model, batches[k], gen, tf)
        losses.append(float(out.loss))
        if k == 0:
            for name, p in model.named_parameters():
                sq = opt.state.get(p, {}).get("square_avg")
                first_grads[name] = (math.sqrt(float(sq.double().sum())
                                               / (1.0 - oc["rho"]))
                                     if sq is not None else float("nan"))
            change1 = _change(before, _state(model))
    change = _change(before, _state(model))
    del before
    if cuda:
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t0

    b = mix["batch"]
    # The judged window step: drawn from the seed among the window's steps
    # after its first (which a traced run profiles).
    judged = mix["anchor_steps"] + int(T.rng(run.seed, T.STREAM_SAMPLE)
                                       .integers(1, 1 + mix["sample_from"]))

    def one(i: int, profiled_unit: bool) -> dict:
        u0 = time.perf_counter()
        ahead = _host_state(model, opt) if i == judged else None
        out = step(model, batches[i % len(batches)], gen, tf)
        loss = float(out.loss)
        if ahead is not None:
            run.extra["window_step"] = {
                "index": i, "loss": loss, "before": ahead,
                "after": _host_state(model, opt),
                "params": [k for k, _ in model.named_parameters()]}
        return {"index": i, "clips": b, "t0": u0, "t1": time.perf_counter(),
                "profiled": profiled_unit, "finite": math.isfinite(loss)}

    n_prof = mix.get("profile_units", 1) if run.traced else 0
    i = mix["anchor_steps"]
    w0 = time.perf_counter()
    if n_prof:
        units, run.trace, _ = profiled(
            lambda: [one(i + j, True) for j in range(n_prof)])
        run.units.extend(units)
        i += n_prof
    while time.perf_counter() - w0 < run.seconds or i <= judged:
        run.units.append(one(i, False))
        i += 1
    if cuda:
        torch.cuda.synchronize()
    run.units[-1]["t1"] = time.perf_counter()
    run.window_s = run.units[-1]["t1"] - w0
    run.attempted = sum(u["clips"] for u in run.units)
    run.failed = 0
    if cuda:
        run.window_peak_bytes = torch.cuda.max_memory_allocated()
        run.peak_bytes = max(run.peak_bytes, run.window_peak_bytes)
    run.extra["widths"] = [batches[u["index"] % len(batches)][s].shape[-1]
                           for u in run.units[:1] for s in ("upper", "lower")]
    run.extra["nonfinite"] = sum(not u["finite"] for u in run.units)
    del model, opt, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    program = {"loss": losses, "grad": first_grads, "change1": change1,
               "change": change,
               "window": window_program(run.extra["window_step"],
                                        oc["rho"])}
    run.extra["program"] = program
    check(run, batches, program)


def _draws(run: Run, batch: dict, gen) -> Draws:
    cfg = run.cell.config
    t_len = max(batch["upper"].shape[-1], batch["lower"].shape[-1])
    return Draws(gen, run.device, batch["audio"].shape[0], cfg["frames"],
                 cfg["model"], t_len, cfg["tf_ratio"])


def _ref_step(run: Run, ref: Reference, batch: dict, gen,
              state: dict) -> tuple:
    """One training step of the reference: the forward with the step's
    draws, the gradients clipped, Adadelta. Returns the loss and each
    leaf's clipped gradient norm."""
    import torch

    oc = run.cell.config["optimizer"]
    audio = torch.from_numpy(batch["audio"]).to(ref.prec.dtype) / 32768.0
    targets = {n: v for n, v in batch.items() if n != "audio"}
    loss, _ = ref.train_forward(audio, targets, _draws(run, batch, gen))
    params = ref.params()
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {n: (g if g is not None else torch.zeros_like(p)).detach()
             for (n, p), g in zip(params.items(), grads)}
    norm = judge.clip_grads(grads, oc["max_grad_norm"])
    value = float(loss.detach())
    if math.isfinite(value) and math.isfinite(float(norm)):
        judge.adadelta_update(params, grads, state, oc["lr"], oc["rho"],
                              oc["eps"])
    return value, {n: float(g.double().norm()) for n, g in grads.items()}


def _ref_state(ref: Reference) -> dict:
    return {n: v.detach() for n, v in ref.p.items()}


def reference_steps(run: Run, batches: list, mode: str = "f64") -> dict:
    """The anchor steps in the reference from the seed: losses, the first
    step's clipped gradient norm per leaf, each leaf's change after the
    first step and after the last."""
    import torch

    cfg, mix = run.cell.config, run.cell.traffic
    ref = Reference(seeded_weights(cfg["model"], run.seed, run.device),
                    cfg["model"], cfg["vqt"], cfg["frames"], mode,
                    run.device, requires_grad=True)
    start = {k: v.detach().clone() for k, v in ref.p.items()}
    gen = torch.Generator(device=run.device)
    gen.manual_seed(step_seed(run.seed))
    state: dict = {}
    losses, first, change1 = [], {}, {}
    for k in range(mix["anchor_steps"]):
        loss, grads = _ref_step(run, ref, batches[k], gen, state)
        losses.append(loss)
        if k == 0:
            first = grads
            change1 = _change(start, _ref_state(ref))
    return {"loss": losses, "grad": first, "change1": change1,
            "change": _change(start, _ref_state(ref)),
            "min_margin": ref.min_margin}


def reference_window(run: Run, batches: list, ws: dict,
                     mode: str = "f64") -> dict:
    """The judged window step in the reference, from the program's model
    and Adadelta state before it, with the draws of a generator seeded
    like the step's and advanced through every earlier step's."""
    import torch

    cfg = run.cell.config
    ref = Reference(ws["before"]["state"], cfg["model"], cfg["vqt"],
                    cfg["frames"], mode, run.device, requires_grad=True)
    start = {k: v.detach().clone() for k, v in ref.p.items()}
    state = {k: tuple(t.to(run.device, ref.prec.dtype).clone() for t in v)
             for k, v in ws["before"]["opt"].items()}
    gen = torch.Generator(device=run.device)
    gen.manual_seed(step_seed(run.seed))
    for k in range(ws["index"]):
        _draws(run, batches[k % len(batches)], gen)
    loss, grads = _ref_step(run, ref, batches[ws["index"] % len(batches)],
                            gen, state)
    return {"loss": [loss], "grad": grads,
            "change": _change(start, _ref_state(ref))}


def _kept(ref: dict) -> set:
    """Leaves whose change is compared: those the reference's gradient
    moves (judge.moved_leaves) and the BatchNorm buffers."""
    return judge.moved_leaves(ref["grad"]) | {
        k for k in ref["change"] if k not in ref["grad"]}


def readings(program: dict, ref: dict) -> dict:
    """The anchor steps' readings: the first step's relative loss gap
    ("loss1_gap") and the worst step's ("loss_gap"), the worst leaf's gap
    of first-gradient norms, and of change norms the median leaf's and the
    worst leaf's after the first step ("change1_median_gap",
    "change1_gap") and after the anchor steps."""
    loss = max(judge.relative_gap(p, r)
               for p, r in zip(program["loss"], ref["loss"]))
    loss1 = judge.relative_gap(program["loss"][0], ref["loss"][0])
    grad, grad_leaf = judge.worst_leaf(program["grad"], ref["grad"])
    keep = _kept(ref)
    change, change_leaf = judge.worst_leaf(program["change"], ref["change"],
                                           keep)
    change1, change1_leaf = judge.worst_leaf(program["change1"],
                                             ref["change1"], keep)
    return {"loss1_gap": loss1, "loss_gap": loss, "grad_gap": grad,
            "change_gap": change,
            "change_median_gap": judge.median_leaf(program["change"],
                                                   ref["change"], keep),
            "change1_gap": change1,
            "change1_median_gap": judge.median_leaf(program["change1"],
                                                    ref["change1"], keep),
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "change1_leaf": change1_leaf}


def window_readings(program: dict, ref: dict) -> dict:
    """The judged window step's readings, from the same state on both
    sides: the relative loss gap, the worst leaf's gap of gradient norms,
    and of change norms the worst and the median leaf's."""
    keep = _kept(ref)
    grad, grad_leaf = judge.worst_leaf(program["grad"], ref["grad"])
    change, change_leaf = judge.worst_leaf(program["change"], ref["change"],
                                           keep)
    return {"win_loss_gap": judge.relative_gap(program["loss"][0],
                                               ref["loss"][0]),
            "win_grad_gap": grad, "win_change_gap": change,
            "win_change_median_gap": judge.median_leaf(
                program["change"], ref["change"], keep),
            "win_grad_leaf": grad_leaf, "win_change_leaf": change_leaf}


def check(run: Run, batches: list, program: dict) -> None:
    t0 = time.perf_counter()
    ref = reference_steps(run, batches)
    ref["window"] = reference_window(run, batches, run.extra["window_step"])
    run.extra["reference"] = ref
    run.extra["check_s"] = time.perf_counter() - t0
    r = {**readings(program, ref),
         **window_readings(program["window"], ref["window"])}
    run.extra["leaves"] = {k: v for k, v in r.items()
                           if k.endswith("_leaf")}
    run.extra["diagnostics"] = {
        **{k: v for k, v in r.items() if k.endswith("_gap")},
        "window_index": run.extra["window_step"]["index"],
        "min_margin_fed": ref["min_margin"],
        "loss": program["loss"], "ref_loss": ref["loss"]}
    lim = run.cell.limits
    for name in sorted(lim):
        if name in r:
            value = r[name] if math.isfinite(r[name]) else float("inf")
            run.check(name, value, lim[name])
    run.check("window_nonfinite", run.extra["nonfinite"], 0)
    run.extra["batches"] = batches


def control(run: Run) -> dict:
    """The control's readings: the reference in TF32 in the program's
    place, held against the float64 reference (bench_port/calibrate.py)."""
    batches, ref = run.extra["batches"], run.extra["reference"]
    ctl = reference_steps(run, batches, "tf32")
    win = reference_window(run, batches, run.extra["window_step"], "tf32")
    r = {**readings(ctl, ref), **window_readings(win, ref["window"])}
    return {k: v for k, v in r.items() if k.endswith("_gap")}
