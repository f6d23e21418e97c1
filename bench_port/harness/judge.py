"""The comparisons that decide ``correct``.

Serving: the greedy decode's outputs are held against the reference run
over the same audio with the same tokens fed back (``judge_served``):

- ``stop_structure`` derives from the served tokens where each stop group
  of each staff had to stop (the step after its last clip's first <eos>,
  or the cap), the lengths that follow, and counts the tokens written
  after a stop and the lengths that disagree: both must be 0.
- ``token_gaps`` reads, at every position a stop group decoded, how far
  the served token's log-probability lies below the reference's best one
  (and the same for the time and key signatures): the widest gap is held
  to a limit.

Training: losses, first gradients and the parameters' change, each as the
gap between the program's reading and the reference's, relative.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def pick_group(decode_chunk, batch: int) -> int:
    """Rows per stop group of a float32 greedy decode of ``batch`` rows:
    "auto" means 16, a batch at or under the group size is one group, a
    size that does not divide the batch steps down to one that does (and
    1 means one group)."""
    if decode_chunk in (None, 0, False):
        return batch
    chunk = 16 if decode_chunk == "auto" else int(decode_chunk)
    if batch <= chunk:
        return batch
    while batch % chunk:
        chunk -= 1
    return chunk if chunk > 1 else batch


def stop_structure(tokens: np.ndarray, lengths: np.ndarray, eos: int,
                   group: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """One staff's served tokens (B, bars, cap) and lengths (B, bars) ->
    (stops (bars, groups), derived lengths (B, bars), mismatches).

    A group stops at the step after the last of its clips' first <eos>, or
    at the cap if one of them has none; a clip's length is its last <eos>
    before the stop plus one, or the cap. Mismatches count nonzero tokens
    at or after a group's stop and lengths other than the derived ones."""
    b, bars, cap = tokens.shape
    groups = b // group
    is_eos = tokens == eos
    has = is_eos.any(axis=2)
    first = np.where(has, is_eos.argmax(axis=2), cap)          # (B, bars)
    stops = np.minimum(first.reshape(groups, group, bars).max(axis=1) + 1,
                       cap).T                                   # (bars, G)
    stop_row = np.repeat(stops.T, group, axis=0)               # (B, bars)
    steps = np.arange(cap)
    before = steps[None, None, :] < stop_row[..., None]
    late = int(np.count_nonzero(tokens[~before]))
    valid = is_eos & before
    last = cap - 1 - valid[..., ::-1].argmax(axis=2)
    derived = np.where(valid.any(axis=2), last + 1, cap)
    return stops, derived, late + int(np.count_nonzero(derived != lengths))


def token_gaps(logp: torch.Tensor, tokens: np.ndarray,
               stops: np.ndarray, group: int) -> Tuple[float, int]:
    """Widest gap (reference best log-prob minus the served token's) over
    the positions each group decoded, and the number of positions judged.
    logp (B, bars, cap, V); tokens (B, bars, cap); stops (bars, G)."""
    lp = logp.double()
    tok = torch.as_tensor(tokens, dtype=torch.long)
    gap = lp.max(dim=-1).values - lp.gather(-1, tok[..., None])[..., 0]
    stop_row = torch.as_tensor(np.repeat(stops.T, group, axis=0))
    mask = torch.arange(tokens.shape[-1])[None, None] < stop_row[..., None]
    judged = int(mask.sum())
    return (float(gap[mask].max()) if judged else 0.0), judged


def head_gaps(logp: torch.Tensor, served: np.ndarray) -> float:
    lp = logp.double()
    idx = torch.as_tensor(served, dtype=torch.long)
    return float((lp.max(dim=-1).values
                  - lp.gather(-1, idx[..., None])[..., 0]).max())


def logp_error(ref_out: dict, other: dict, served: dict, model: dict,
               decode_chunk) -> float:
    """The largest |log-prob - reference log-prob| over the whole
    vocabulary at every position the served batch's groups decoded, and
    over the signature heads' classes."""
    b = served["upper"].shape[0]
    group = pick_group(decode_chunk, b)
    if any(other[k].shape != ref_out[k].shape for k in ref_out):
        return float("inf")
    err = 0.0
    for staff in ("upper", "lower"):
        stops, _, _ = stop_structure(served[staff], served[f"{staff}_len"],
                                     model["eos"], group)
        stop_row = torch.as_tensor(np.repeat(stops.T, group, axis=0))
        cap = served[staff].shape[-1]
        mask = torch.arange(cap)[None, None] < stop_row[..., None]
        if mask.any():
            diff = (other[staff].double() - ref_out[staff].double()).abs()
            err = max(err, float(diff[mask].max()))
    for head in ("time_sig", "key"):
        err = max(err, float((other[head].double()
                              - ref_out[head].double()).abs().max()))
    return err


def served_readings(ref_out: dict, served: dict, model: dict,
                    decode_chunk, prog_logp: Optional[dict] = None) -> dict:
    """The numbers one served batch gives: "gap" (the widest token gap, the
    signatures' included), "stop_mismatch" (count), "judged" (positions)
    and, given the decode's own log-probs, "logp_err" (``logp_error``)."""
    b = served["upper"].shape[0]
    group = pick_group(decode_chunk, b)
    gap, judged, mism = 0.0, 0, 0
    for staff in ("upper", "lower"):
        stops, _, bad = stop_structure(served[staff], served[f"{staff}_len"],
                                       model["eos"], group)
        g, n = token_gaps(ref_out[staff], served[staff], stops, group)
        gap, judged, mism = max(gap, g), judged + n, mism + bad
    for head in ("time_sig", "key"):
        gap = max(gap, head_gaps(ref_out[head], served[head]))
        judged += served[head].size
    out = {"gap": gap, "stop_mismatch": mism, "judged": judged}
    if prog_logp is not None:
        out["logp_err"] = logp_error(ref_out, prog_logp, served, model,
                                     decode_chunk)
    return out


def served_lengths(served: dict, model: dict, decode_chunk) -> dict:
    """The served batch with each staff's lengths derived from its tokens
    (what the reference conditions the next bar on)."""
    b = served["upper"].shape[0]
    group = pick_group(decode_chunk, b)
    out = dict(served)
    for staff in ("upper", "lower"):
        _, derived, _ = stop_structure(served[staff], served[f"{staff}_len"],
                                       model["eos"], group)
        out[f"{staff}_len"] = derived
    return out


def control_readings(ref_out: dict, ctl_out: dict, served: dict,
                     model: dict, decode_chunk) -> dict:
    """The control's readings: at each position the served batch's groups
    decoded, the reference's gap of the token the lower precision puts
    first ("token_gap"), and its log-probs' error ("logp_err")."""
    b = served["upper"].shape[0]
    group = pick_group(decode_chunk, b)
    gap = 0.0
    for staff in ("upper", "lower"):
        stops, _, _ = stop_structure(served[staff], served[f"{staff}_len"],
                                     model["eos"], group)
        first = ctl_out[staff].argmax(dim=-1).numpy()
        gap = max(gap, token_gaps(ref_out[staff], first, stops, group)[0])
    for head in ("time_sig", "key"):
        gap = max(gap, head_gaps(ref_out[head],
                                 ctl_out[head].argmax(dim=-1).numpy()))
    return {"token_gap": gap,
            "logp_err": logp_error(ref_out, ctl_out, served, model,
                                   decode_chunk)}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def relative_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[set] = None) -> Tuple[float, str]:
    """The largest |prog - ref| of per-leaf norms, each over the larger of
    the reference leaf's norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    worst, which = 0.0, ""
    for k in names:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not g <= worst:          # NaN (a leaf the program never moved) too
            worst, which = (g if g == g else float("inf")), k
    return worst, which


def median_leaf(prog: Dict[str, float], ref: Dict[str, float],
                keep: Optional[set] = None) -> float:
    """The median over leaves of |prog - ref| / max(ref, median leaf): a
    reading that one small leaf's round-off does not move."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names]
    return statistics.median(g if g == g else float("inf") for g in gaps)


def moved_leaves(ref_grads: Dict[str, float]) -> set:
    """Leaves whose first gradient is at least a thousandth of the median
    leaf's: the others move under Adadelta by round-off alone."""
    med = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v >= 1e-3 * med}


def adadelta_update(params: Dict[str, torch.Tensor],
                    grads: Dict[str, torch.Tensor], state: dict,
                    lr: float, rho: float, eps: float) -> None:
    """Adadelta (Zeiler 2012) with a learning rate: the running mean of the
    squared gradient and of the squared update, the update scaled by the
    ratio of their roots."""
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            sq, acc = state.setdefault(k, (torch.zeros_like(p),
                                           torch.zeros_like(p)))
            sq.mul_(rho).add_((1 - rho) * g * g)
            delta = torch.sqrt(acc + eps) / torch.sqrt(sq + eps) * g
            acc.mul_(rho).add_((1 - rho) * delta * delta)
            p.sub_(lr * delta)


def clip_grads(grads: Dict[str, torch.Tensor], max_norm: float
               ) -> torch.Tensor:
    """Scale every gradient by max_norm / (global norm) where that norm is
    above max_norm; returns the norm before."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if float(norm) > max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm.to(g.dtype))
    return norm
