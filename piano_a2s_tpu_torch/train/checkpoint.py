"""Checkpointing with keep-best-by-metric semantics: the port's
counterpart of piano_a2s_tpu/train/checkpoint.py, with ``torch.save`` in
place of orbax.

A save folder holds checkpoint directories ``CKPT+<stamp>+NN``, each with

    model.pt         the model's state dict (BatchNorm buffers included)
    optimizer.pt     the optimizer's state dict (Adadelta's accumulators)
    host_state.json  NewBob scheduler state, epoch and step counters
    meta.json        metrics (e.g. WER) and the save time, written LAST

``meta.json`` is the commit marker: a directory without it is the debris
of a save that was cut off, invisible to every reader and swept by the
next ``save_and_keep_only``. The recoverables are those of the reference
(hparams/pretrain.yaml:110-116, pretrain.py:185-187); the finetune warm
start (a copy with WER reset; reference: finetune.py:250-258) is
``import_from``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

CKPT_PREFIX = "CKPT"
META = "meta.json"
HOST_STATE = "host_state.json"


def is_checkpoint(path: str) -> bool:
    """A committed checkpoint directory (its meta.json exists)."""
    return (os.path.basename(os.path.normpath(path)).startswith(CKPT_PREFIX)
            and os.path.exists(os.path.join(path, META)))


class Checkpointer:
    def __init__(self, checkpoints_dir: str):
        # No makedirs here: loading from a mistyped path must not leave
        # empty directories behind (dirs are created on the save paths).
        self.dir = os.path.abspath(checkpoints_dir)

    # -- enumeration --------------------------------------------------------

    def _ckpt_dirs(self) -> List[str]:
        if not os.path.isdir(self.dir):
            return []
        return sorted(os.path.join(self.dir, d) for d in os.listdir(self.dir)
                      if is_checkpoint(os.path.join(self.dir, d)))

    def _read_meta(self, path: str) -> Dict[str, Any]:
        with open(os.path.join(path, META)) as f:
            return json.load(f)

    # -- save ---------------------------------------------------------------

    def save(self, trees: Dict[str, Any], meta: Dict[str, Any],
             host_state: Optional[Dict[str, Any]] = None) -> str:
        """Save one checkpoint: each of ``trees`` (state dicts: "model",
        "optimizer") to <name>.pt, ``host_state`` (JSON) and then ``meta``
        (metrics), atomically, last."""
        # The count suffix must give an UNUSED dir: after keep-only-best
        # deletions the dir count is non-monotonic, so two improving epochs
        # within one wall-clock second could collide on the same tag.
        os.makedirs(self.dir, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d+%H-%M-%S")
        count = len(self._ckpt_dirs())
        while os.path.exists(os.path.join(
                self.dir, f"{CKPT_PREFIX}+{stamp}+{count:02d}")):
            count += 1
        path = os.path.join(self.dir, f"{CKPT_PREFIX}+{stamp}+{count:02d}")
        os.makedirs(path)
        for name, tree in trees.items():
            torch.save(tree, os.path.join(path, f"{name}.pt"))
        with open(os.path.join(path, HOST_STATE), "w") as f:
            json.dump(host_state or {}, f, indent=2)
        # A kill mid-write must not leave a partial meta.json that makes
        # the dir enumerable but unparseable.
        tmp = os.path.join(path, ".meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"unixtime": time.time(), **meta}, f, indent=2)
        os.replace(tmp, os.path.join(path, META))
        return path

    def save_and_keep_only(self, trees, meta, host_state=None,
                           min_keys: Tuple[str, ...] = ("WER",)) -> str:
        """Save, then delete every checkpoint that is not the best (lowest)
        on one of ``min_keys`` (union kept). Sweeps incomplete CKPT dirs
        (no meta.json) first, and skips a save that would improve no key
        (it would be deleted at once; ties keep the older checkpoint)."""
        os.makedirs(self.dir, exist_ok=True)
        # Sweep debris FIRST, unconditionally: the skip path below must not
        # let crashed-save dirs accumulate across runs whose metric never
        # improves again.
        for d in os.listdir(self.dir):
            full = os.path.join(self.dir, d)
            if (d.startswith(CKPT_PREFIX) and os.path.isdir(full)
                    and not os.path.exists(os.path.join(full, META))):
                shutil.rmtree(full)
        existing = self._ckpt_dirs()
        if existing:
            inf = float("inf")
            improves = any(
                float(meta.get(k, inf)) < min(
                    float(self._read_meta(c).get(k, inf)) for c in existing)
                for k in min_keys)
            if not improves:
                return self.best_path(min_keys[0]) or existing[0]
        path = self.save(trees, meta, host_state)
        ckpts = self._ckpt_dirs()
        keep = set()
        for key in min_keys:
            with_key = [(self._read_meta(c).get(key, float("inf")), c)
                        for c in ckpts]
            keep.add(min(with_key, key=lambda x: x[0])[1])
        for c in ckpts:
            if c not in keep:
                shutil.rmtree(c)
        return path

    # -- load ---------------------------------------------------------------

    def best_path(self, min_key: str = "WER") -> Optional[str]:
        ckpts = self._ckpt_dirs()
        if not ckpts:
            return None
        return min(ckpts, key=lambda c: self._read_meta(c).get(
            min_key, float("inf")))

    def latest_path(self) -> Optional[str]:
        ckpts = self._ckpt_dirs()
        if not ckpts:
            return None
        return max(ckpts, key=lambda c: self._read_meta(c)["unixtime"])

    def load(self, path: str, names: Iterable[str] = ("model", "optimizer")):
        """(trees, host_state, meta) of the checkpoint at ``path``; trees
        maps each of ``names`` to its state dict, on the CPU (load it into
        a module or optimizer on its device)."""
        trees = {name: torch.load(os.path.join(path, f"{name}.pt"),
                                  map_location="cpu", weights_only=True)
                 for name in names}
        with open(os.path.join(path, HOST_STATE)) as f:
            host_state = json.load(f)
        return trees, host_state, self._read_meta(path)

    # -- warm start ---------------------------------------------------------

    def import_from(self, other_dir: str,
                    reset_meta: Optional[Dict[str, Any]] = None,
                    reset_host_state: Optional[Dict[str, Any]] = None
                    ) -> None:
        """Copy the checkpoints of another save folder (the finetune warm
        start), overwriting metric values (e.g. WER=100) and host state
        (e.g. epoch=0: the reference's finetune drops the epoch counter
        from its recoverables, finetune.yaml vs pretrain.yaml:116).

        Imported checkpoints are marked fresh_optimizer=True: the
        reference's recoverables EXCLUDE the optimizer
        (hparams/*.yaml:110-116), so a warm-started finetune runs its first
        epoch with a fresh Adadelta at the config's lr (Trainer.restore)."""
        reset_host_state = dict(reset_host_state or {}, fresh_optimizer=True)
        os.makedirs(self.dir, exist_ok=True)
        for src in Checkpointer(other_dir)._ckpt_dirs():
            dst = os.path.join(self.dir, os.path.basename(src))
            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.copytree(src, dst)
            if reset_meta:
                meta = self._read_meta(dst)
                meta.update(reset_meta)
                with open(os.path.join(dst, META), "w") as f:
                    json.dump(meta, f, indent=2)
            hs_path = os.path.join(dst, HOST_STATE)
            with open(hs_path) as f:
                host_state = json.load(f)
            host_state.update(reset_host_state)
            with open(hs_path, "w") as f:
                json.dump(host_state, f, indent=2)
