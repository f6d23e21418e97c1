"""Arithmetic the metric readers share: the cost of a served batch and of
a training step from the run's configuration and what the window did."""

from __future__ import annotations

from . import counts

K1_KERNELS = ("vqt_mag_kernel", "pad_split_kernel")


def peaks(run):
    p = run.cell.config["peaks"]
    return p["flops_per_s"], p["bytes_per_s"]


def bound_s(run, ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the peak rate or
    bytes at the peak bandwidth, whichever is longer."""
    flops, bw = peaks(run)
    return max(ops / flops, nbytes / bw)


def n_samples(run) -> int:
    cfg = run.cell.config
    return (cfg["frames"] - 1) * cfg["vqt"]["hop_length"]


def is_k1(name: str) -> bool:
    return any(k in name for k in K1_KERNELS)


def profiled(run):
    return [u for u in run.units if u.get("profiled")]


def served_flops(run, unit) -> float:
    cfg = run.cell.config
    return counts.serve_batch_flops(
        cfg["model"], cfg["vqt"], unit["clips"], n_samples(run),
        cfg["frames"], unit["stops"], run.extra["group"])


def decode_steps(unit) -> int:
    return int(unit["stops"].max(axis=(1, 2)).sum())


def idle_pct(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
