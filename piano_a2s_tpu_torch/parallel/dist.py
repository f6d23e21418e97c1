"""Data parallelism over torch.distributed: process group set-up, ranks,
the rows a rank owns, and the few collectives the port uses.

Port of piano_a2s_tpu/parallel/mesh.py. Where the JAX package shards the
batch axis of one program over a device mesh and lets XLA insert the
collectives, the port runs one process per device (torchrun) and issues
them itself: an all-reduce of the gradients, of the loss numerators and of
the BatchNorm sums, a broadcast of rank 0's weights, and barriers. Only
``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo takes CUDA
tensors for no other collective, and gloo on CUDA tensors is how two ranks
share one card (NCCL refuses two ranks on one device).

Every rank must issue the same collectives in the same order. A loop whose
bound is read on one rank alone (a local stop flag, a local bucket width)
hangs the job; such bounds are all-reduced first.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# torchrun's environment (torch.distributed.run).
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def distributed_init(init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     device="cuda", backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the process group and return this rank's device.

    Without ``init_method`` the group comes from torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT), which must be set.
    With it (``tcp://host:port``, or ``file://path``, which needs no free
    port), ``rank`` and ``world_size`` are given. The backend is NCCL for a
    CUDA ``device`` and gloo for the CPU, unless ``backend`` says otherwise
    (gloo on CUDA tensors puts several ranks on one card). A barrier
    follows, as the JAX package's distributed_init syncs right after
    initialising, so that every rank has joined before the first real
    collective.
    """
    if init_method is None:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"data-parallel training runs under torchrun (python -m "
                f"torch.distributed.run --nproc_per_node N ...): "
                f"{', '.join(missing)} not set")
        init_method = "env://"
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # -1: read from the environment (torchrun's RANK and WORLD_SIZE).
    dist.init_process_group(
        backend, init_method=init_method,
        rank=-1 if rank is None else rank,
        world_size=-1 if world_size is None else world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    barrier()
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def local_device(device="cuda") -> torch.device:
    """``device``, with a bare "cuda" resolved to this rank's card
    (cuda:LOCAL_RANK, as torchrun numbers the ranks of a host); a CUDA
    device must exist."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if is_initialized():
        dist.destroy_process_group()


def _comm_device(group) -> torch.device:
    """Where a host-side value must lie for this group's backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(group=None) -> None:
    if is_initialized():
        dist.barrier(group)


def _coalesced(tensors: Sequence[torch.Tensor], collective) -> None:
    """Run ``collective`` in place on one flat buffer per dtype of
    ``tensors`` (which share a device) and copy the result back: one
    collective for many small tensors."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_reduce_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum ``tensors`` over the ranks, in place (the gradients, the loss
    numerators, the eval step's predictions)."""
    _coalesced(tensors, lambda flat: dist.all_reduce(flat, group=group))


def broadcast_module_(module: torch.nn.Module, src: int = 0,
                      group=None) -> None:
    """Every rank gets rank ``src``'s parameters and buffers, in place."""
    with torch.no_grad():
        _coalesced(list(module.parameters()) + list(module.buffers()),
                   lambda flat: dist.broadcast(flat, src=src, group=group))


def broadcast_path(path: Optional[str], group=None) -> Optional[str]:
    """Rank 0's ``path`` (a checkpoint to restore, or None) on every rank,
    so that all ranks take the same branch and issue the same collectives.
    Rank 0 alone writes checkpoints, so the others must see its save
    folder: raises on every rank unless every rank finds ``path``."""
    dev = _comm_device(group)
    data = (path or "").encode()
    size = torch.tensor([-1 if path is None else len(data)],
                        dtype=torch.int64, device=dev)
    dist.broadcast(size, src=0, group=group)
    if int(size.item()) < 0:
        return None
    buf = torch.tensor(list(data), dtype=torch.uint8, device=dev)
    if dist.get_rank(group) != 0:
        buf = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
    dist.broadcast(buf, src=0, group=group)
    path = bytes(buf.cpu().tolist()).decode()
    missing = torch.tensor([int(not os.path.exists(path))],
                           dtype=torch.int64, device=dev)
    dist.all_reduce(missing, group=group)
    if int(missing.item()):
        raise RuntimeError(
            f"{path!r}, rank 0's checkpoint, is missing on "
            f"{int(missing.item())} rank(s): data-parallel training keeps "
            f"its save folder on a filesystem that every rank shares")
    return path


def step_rows(rank: int, world: int, batch: int,
              accum: int = 1) -> Tuple[np.ndarray, int, bool]:
    """(rows, start, owned): the global batch rows rank ``rank`` of
    ``world`` computes in a data-parallel step, in order, their offset in
    every microbatch, and whether the rank owns them.

    Microbatch m of ``accum`` is the global rows [m M, (m+1) M), M = B/A,
    as the JAX package's reshape cuts them, and the rank owns the rows
    [floor(r M / N), floor((r + 1) M / N)) of each, the same count in
    every microbatch: where N divides M the r-th of N equal slices, for
    accum=1 the contiguous range that per-host sharded loading reads.
    Where M < N some ranks own none; such a rank computes one stand-in row
    of each microbatch, the global row at its offset (``owned`` False), so
    that it enters every collective as the others do. The step gives
    stand-ins a sample weight of 0 and leaves them out of the BatchNorm
    statistics, so they add nothing. Raises unless A and N each divide B,
    where the JAX package fails too (its microbatch reshape and its batch
    sharding)."""
    if batch % accum or batch % world:
        raise ValueError(
            f"data parallel: accum_steps and the world size must each "
            f"divide the batch (B={batch}, A={accum}, N={world})")
    micro = batch // accum
    start, stop = rank * micro // world, (rank + 1) * micro // world
    owned = start < stop
    offsets = np.arange(start, stop if owned else start + 1)
    rows = (np.arange(accum)[:, None] * micro + offsets).reshape(-1)
    return rows.astype(np.int64), start, owned


def local_rows(rank: int, world: int, batch: int,
               accum: int = 1) -> np.ndarray:
    """The global batch rows rank ``rank`` of ``world`` owns, in order:
    ``step_rows`` without stand-ins (empty where M < N leaves it none)."""
    rows, _, owned = step_rows(rank, world, batch, accum)
    return rows if owned else rows[:0]


def assert_ranks_agree(host_batch: Dict[str, Any], group=None) -> None:
    """Fail on every rank unless all ranks hold the same arrays: the
    SHA-256 digest of each value against rank 0's (the twin of the JAX
    harness's _assert_hosts_agree). Raises ValueError ("batch mismatch")."""
    digest = []
    for k in sorted(host_batch):
        v = np.ascontiguousarray(np.asarray(host_batch[k]))
        h = hashlib.sha256(str(v.dtype).encode() + str(v.shape).encode()
                           + v.tobytes()).digest()
        digest.append(np.frombuffer(h[:8], np.int64)[0])
    dev = _comm_device(group)
    mine = torch.tensor(digest, dtype=torch.int64, device=dev)
    ref = mine.clone()
    dist.broadcast(ref, src=0, group=group)
    # Every rank learns whether any rank differs, so all of them raise.
    bad = (mine != ref).any().to(torch.int64).reshape(1)
    dist.all_reduce(bad, group=group)
    if int(bad.item()):
        raise ValueError(
            "data-parallel batch mismatch: every rank must construct the "
            "same global batch (identical DataLoader seed and dataset "
            "listing order)")
