"""Seeded weights, made on the device in a few large draws.

Both sides get the same dict: the program loads it as its state dict, and
the reference reads it by name. ``eos_bias`` (per staff) is added to the
<eos> logit's bias of each note decoder's output head, which sets how soon
a greedy decode stops.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .reference import param_spec


def seeded_weights(model: dict, seed: int, device,
                   eos_bias: Optional[Sequence[float]] = None
                   ) -> Dict[str, torch.Tensor]:
    """The state dict of ``model``'s sizes drawn from ``seed`` on
    ``device``: one uniform and one normal draw over all tensors, cut and
    scaled per tensor (``reference.param_spec``), float32."""
    spec = param_spec(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_int(seed))
    n_uni = sum(_numel(s) for _, s, k, _ in spec if k == "uniform")
    n_norm = sum(_numel(s) for _, s, k, _ in spec if k == "normal")
    uni = torch.rand(n_uni, generator=gen, device=device).mul_(2.0).sub_(1.0)
    norm = torch.randn(n_norm, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = {"uniform": 0, "normal": 0}
    for name, shape, kind, scale in spec:
        n = _numel(shape)
        if kind == "const":
            out[name] = torch.full(shape, scale, device=device)
            continue
        src = uni if kind == "uniform" else norm
        out[name] = (src[at[kind]:at[kind] + n] * scale).reshape(shape)
        at[kind] += n
    for name, _, kind, _ in spec:
        if name.endswith("running_var"):
            out[name.replace("running_var", "num_batches_tracked")] = \
                torch.zeros((), dtype=torch.long, device=device)
    if eos_bias is not None:
        for staff, bias in zip(("upper", "lower"), eos_bias):
            out[f"decoder.{staff}_decoder.out.bias"][model["eos"]] += bias
    return out


def seed_int(seed: int) -> int:
    """A run's seed as the 64-bit value that torch's generators take."""
    return int(seed) % (1 << 63)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
