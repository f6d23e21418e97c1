"""Dataset loaders: a copy of piano_a2s_tpu/data/datasets.py.

Host-side numpy implementations of the reference's dataset contract
(reference: datasets/syn.py, datasets/asap.py:276-401). Items stay on the
host as numpy; the Trainer moves each batch to the device once per step.
The loader builds numpy only: its prefetch thread touches no device.

On-disk layout (identical to the reference):
  {feature_folder}/{split}/{version}/spectrogram/{name}.npy   (T, 480)
  {feature_folder}/{split}/{version}/target/{name}.pkl
      pickle: list of per-measure [key, time_sig, lower_tokens, upper_tokens]
  {feature_folder}/{split}/{version}/info/{name}.json         (composer etc.)
  {feature_folder}/{split}/{version}/audio/{name}.npy         optional: raw
      mono clip @ model rate (f32 in [-1,1] or int16 PCM) - read instead of
      spectrograms with input_features="audio" (the log-VQT then runs on
      the device inside the train and eval steps;
      train/step.make_audio_frontend)
  The ASAP layout has no {version} level: {feature_folder}/{split}/...

Item contract (the reference's 9-tuple, as a dict):
  spectrogram (1, max_frame_num, 480) f32; time_sig (bars,) i32 (index into
  the 7-entry table); key (bars,) i32 (signature + 6 -> 0..13); upper/lower
  (bars, max_len) i32 padded with <pad>, <eos> after the last token;
  upper_lengths/lower_lengths (bars,) i32 = min(len, max_len) WITHOUT the
  EOS; name; version.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..parallel import step_rows
from ..symbolic.vocab import LabelsMultiple

_METADATA_DIR = os.path.join(os.path.dirname(__file__), "metadata")


def load_time_signatures() -> List[str]:
    with open(os.path.join(_METADATA_DIR, "time_signature_list.json")) as f:
        return json.load(f)


def load_split_list(name: str) -> List[str]:
    with open(os.path.join(_METADATA_DIR, name)) as f:
        return [line.strip() for line in f if line.strip()]


def _load_npy(path: str) -> np.ndarray:
    return np.load(path)


def _load_pkl(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _list_feature_names(folder: str, feature_key: str) -> List[str]:
    """Song names under {folder} (a .../{feature_key} dir), with a
    diagnosis instead of a bare FileNotFoundError when the layout lacks
    the configured feature mode."""
    if not os.path.isdir(folder):
        hint = ("input_features='audio' reads {split}/.../audio/*.npy "
                "(model-rate PCM). data/synth.py and the prepare_data "
                "spectrogram stages write it; feature folders prepared "
                "before the audio mode existed only have spectrogram/ — "
                "re-run the spectrogram stage to backfill audio/."
                if feature_key == "audio" else
                "run prepare_data (or data/synth.py) to build features.")
        raise FileNotFoundError(f"{folder}: missing — {hint}")
    return sorted(s[:-4] for s in os.listdir(folder))


class _DatasetBase:
    def __init__(self, feature_folder: str, split: str,
                 max_frame_num: int = 1201,
                 max_length=(398, 189),
                 input_features: str = "spectrogram",
                 max_samples: Optional[int] = None,
                 hop_length: int = 160):
        """input_features="audio" reads raw clips ({...}/audio/{name}.npy,
        float32 in [-1,1] or int16 PCM at the model sample rate — the
        layout data/synth.py and prepare_data's ASAP pass write) instead
        of precomputed spectrograms; the train/eval steps then run the
        log-VQT frontend on device (train/step.make_audio_frontend).
        max_samples defaults to (max_frame_num-1)*hop_length; pass
        max_samples (ExperimentConfig.max_samples is the CLI source of
        truth) or hop_length when the VQT hop is non-default."""
        if input_features not in ("spectrogram", "audio"):
            raise ValueError(f"input_features={input_features!r}: "
                             f"'spectrogram' or 'audio'")
        self.feature_folder = feature_folder
        self.split = split
        self.feature_key = input_features
        self.max_frame_num = max_frame_num
        self.max_samples = (max_samples if max_samples is not None
                            else (max_frame_num - 1) * hop_length)
        self.max_length = tuple(max_length)
        self.time_sig_list = load_time_signatures()
        self.time_sig_dict = {t: i for i, t in enumerate(self.time_sig_list)}
        self.labels = LabelsMultiple(extended=True)
        self.pad_id = self.labels.labels_map["<pad>"]
        self.eos_id = self.labels.labels_map["<eos>"]

    # -- padding helpers (reference: syn.py:46-74) --------------------------

    def pad_spectrogram(self, spec: np.ndarray) -> np.ndarray:
        out = np.zeros((self.max_frame_num, spec.shape[-1]), np.float32)
        n = min(spec.shape[0], self.max_frame_num)
        out[:n] = spec[:n]
        return out[None]  # (1, T, bins)

    def pad_single_measure(self, measure: Sequence[int],
                           max_length: int) -> np.ndarray:
        out = np.full((max_length,), self.pad_id, np.int32)
        m = list(measure)[:max_length]
        out[: len(m)] = m
        if len(m) < max_length:
            out[len(m)] = self.eos_id
        return out

    def pad_score(self, score: List[Sequence[int]], max_length: int):
        if not score:
            # Zero-measure target (truncated/corrupt pickle): the
            # reference's torch.zeros((0, max_length)) shape, not a
            # np.stack([]) ValueError in the loader thread.
            return (np.zeros((0, max_length), np.int32),
                    np.zeros((0,), np.int32))
        padded = np.stack([self.pad_single_measure(m, max_length)
                           for m in score])
        lengths = np.array([min(len(m), max_length) for m in score],
                           np.int32)
        return padded, lengths

    # -- item assembly -------------------------------------------------------
    #
    # Items split into a LOCATOR (which files; consumes any sampling RNG),
    # the TARGET half (small pickle — every host loads all of these in
    # per-host sharded multi-host loading, keeping length bucketing and the
    # cross-host batch contract global), and the SPECTROGRAM half (the
    # heavy .npy IO — loaded only for a host's own shard rows).

    def load_target(self, locator) -> Dict[str, Any]:
        feature_folder, spectrogram_name, _ = locator
        target_name = spectrogram_name.split("~")[0]
        score = _load_pkl(os.path.join(feature_folder, "target",
                                       f"{target_name}.pkl"))
        key = np.array([int(m[0]) for m in score], np.int32) + 6
        time_sig = np.array([self.time_sig_dict[m[1]] for m in score],
                            np.int32)
        upper, upper_len = self.pad_score([m[3] for m in score],
                                          self.max_length[0])
        lower, lower_len = self.pad_score([m[2] for m in score],
                                          self.max_length[1])
        return {"time_sig": time_sig, "key": key,
                "upper": upper, "upper_lengths": upper_len,
                "lower": lower, "lower_lengths": lower_len}

    def pad_audio(self, audio: np.ndarray) -> np.ndarray:
        """Trim/zero-pad a mono clip to max_samples — the same contract
        serving ingest uses (utils.audio.trim_pad_audio: int16 preserved
        for half-byte uploads, converted on device)."""
        from ..utils.audio import trim_pad_audio
        return trim_pad_audio(audio, self.max_samples)

    def load_spectrogram(self, locator) -> np.ndarray:
        feature_folder, spectrogram_name, _ = locator
        spec = _load_npy(os.path.join(feature_folder, "spectrogram",
                                      f"{spectrogram_name}.npy"))
        return self.pad_spectrogram(spec)

    def load_features(self, locator) -> np.ndarray:
        """The heavy per-item array under the configured feature_key."""
        if self.feature_key == "spectrogram":
            return self.load_spectrogram(locator)
        feature_folder, name, _ = locator
        return self.pad_audio(_load_npy(
            os.path.join(feature_folder, "audio", f"{name}.npy")))

    def _item(self, feature_folder: str, spectrogram_name: str,
              version) -> Dict[str, Any]:
        locator = (feature_folder, spectrogram_name, version)
        return {self.feature_key: self.load_features(locator),
                **self.load_target(locator),
                "name": spectrogram_name, "version": version}


class SyntheticTrainDataset(_DatasetBase):
    """Random version (of the 10 renderings) per item
    (reference: syn.py:76-121)."""

    def __init__(self, feature_folder: str, split: str = "train",
                 versions=range(10), rng: Optional[np.random.RandomState]
                 = None, **kw):
        super().__init__(feature_folder, split, **kw)
        self.versions = list(versions)
        # Default to a FIXED seed, not OS entropy: per-host sharded
        # multi-host loading requires every host's version-sampling RNG
        # to run in lockstep so locate() agrees on the same
        # (folder, name, version) for a given global row — an entropy
        # default would silently hand each host different targets.
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.song_list: Dict[Any, List[str]] = {}
        self.lengths: Dict[Any, int] = {}
        for v in self.versions:
            folder = os.path.join(feature_folder, split, str(v),
                                  self.feature_key)
            songs = _list_feature_names(folder, self.feature_key)
            self.song_list[v] = songs
            self.lengths[v] = len(songs)

    def __len__(self) -> int:
        return max(self.lengths.values())

    def locate(self, idx: int):
        """Draw this item's (folder, name, version); consumes the version-
        sampling RNG, so all hosts calling locate for the same global index
        stream stay in lockstep."""
        v = self.versions[self.rng.randint(len(self.versions))]
        folder = os.path.join(self.feature_folder, self.split, str(v))
        songs = self.song_list[v]
        return (folder, songs[idx % len(songs)], v)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self._item(*self.locate(idx))


class SyntheticTestDataset(_DatasetBase):
    """Enumerates (song, version) pairs (reference: syn.py:123-170)."""

    def __init__(self, feature_folder: str, split: str,
                 versions=(0,), **kw):
        super().__init__(feature_folder, split, **kw)
        self.items: List[tuple] = []
        for v in versions:
            folder = os.path.join(feature_folder, split, str(v),
                                  self.feature_key)
            for song in _list_feature_names(folder, self.feature_key):
                self.items.append((song, v))

    def __len__(self) -> int:
        return len(self.items)

    def locate(self, idx: int):
        name, v = self.items[idx]
        folder = os.path.join(self.feature_folder, self.split, str(v))
        return (folder, name, v)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self._item(*self.locate(idx))


class ASAPDataset(_DatasetBase):
    """Real-recording dataset; single version named 'asap'
    (reference: asap.py:276-401)."""

    def __init__(self, feature_folder: str, split: str, **kw):
        super().__init__(feature_folder, split, **kw)
        folder = os.path.join(feature_folder, split, self.feature_key)
        self.songs = _list_feature_names(folder, self.feature_key)

    def __len__(self) -> int:
        return len(self.songs)

    def locate(self, idx: int):
        folder = os.path.join(self.feature_folder, self.split)
        return (folder, self.songs[idx], "asap")

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self._item(*self.locate(idx))


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack items into a device-ready batch dict (+ host-side names).
    Audio stacks via stack_audio_batch: a corpus mixing int16 and f32
    audio/ files (e.g. synth.py f32 versions next to prepare_data's
    int16 backfill) would otherwise put raw int16 VALUES into a float
    batch — wrong by 32768x and silent."""
    from ..utils.audio import stack_audio_batch

    batch = {}
    for k in ("spectrogram", "audio", "time_sig", "key", "upper",
              "upper_lengths", "lower", "lower_lengths"):
        if k not in items[0]:
            continue
        batch[k] = (stack_audio_batch([it[k] for it in items])
                    if k == "audio"
                    else np.stack([it[k] for it in items]))
    batch["names"] = [it["name"] for it in items]
    batch["versions"] = [it["version"] for it in items]
    return batch


class DataLoader:
    """Host-side loader: shuffling + batching + optional padding of the
    final batch to a full batch (every batch has the same shape; "n_real"
    counts the real rows), with background-thread prefetch so disk IO
    overlaps device compute.

    Per-host sharded loading for data parallelism (shard=(rank, world)):
    every host draws the SAME global batch plan (same
    seed, same dataset listing order, same sampling-RNG stream via
    dataset.locate) and loads every row's TARGET (small pickles — keeps
    length bucketing and the cross-host batch contract a pure function of
    global state), but loads SPECTROGRAMS (the heavy IO) only for its own
    rows. The batch then carries "local_rows", the index array of those
    rows, and a feature array of those rows. The rows are the ones the
    rank computes, ``parallel.step_rows(rank, world, batch_size,
    accum_steps)``: with gradient accumulation each rank owns its slice of
    every microbatch (or, where a microbatch has fewer rows than there are
    ranks and it owns none, a stand-in row of each); with accum_steps=1
    the contiguous range the JAX package's loader reads. The data-parallel
    Trainer (use_mesh=True) checks them against its own.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, pad_final_batch: bool = True,
                 prefetch: int = 2, shard=None, accum_steps: int = 1):
        self.dataset = dataset
        # Optional per-batch hook, applied where batches are BUILT — i.e.
        # inside the prefetch producer thread — so host-side staging work
        # (e.g. the Trainer's f16 upload cast) overlaps device compute
        # instead of running serially in the training loop.
        self.transform = None
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.pad_final_batch = pad_final_batch
        self.prefetch = prefetch
        if shard is not None:
            rank, world = shard
            if not (0 <= rank < world):
                raise ValueError(f"bad shard {shard}")
            if world > 1:
                if batch_size % world or batch_size % accum_steps:
                    raise ValueError(
                        f"the world size ({world}) and accum_steps "
                        f"({accum_steps}) must divide batch_size="
                        f"{batch_size} for per-host loading")
                if not pad_final_batch:
                    raise ValueError("per-host sharded loading requires "
                                     "pad_final_batch (static row ranges)")
                if not hasattr(dataset, "locate"):
                    raise ValueError("dataset must expose locate()/"
                                     "load_target()/load_spectrogram() for "
                                     "per-host sharded loading")
            else:
                shard = None  # single process: plain loading
        self.shard = shard
        self.accum_steps = accum_steps

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _sharded_batch(self, idxs, n_real):
        rank, world = self.shard
        locators = [self.dataset.locate(int(i)) for i in idxs]
        if len(locators) < self.batch_size:  # pad_final_batch, globally
            locators += [locators[-1]] * (self.batch_size - len(locators))
        # Load each distinct locator once: padding replicates the final
        # locator (and random-version sampling can repeat one), so a
        # naive per-row load would re-read the same files many times.
        t_cache, s_cache = {}, {}

        def load_t(loc):
            if loc not in t_cache:
                t_cache[loc] = self.dataset.load_target(loc)
            return t_cache[loc]

        # Custom datasets without the feature_key/load_features surface
        # keep working through the spectrogram names.
        feature_key = getattr(self.dataset, "feature_key", "spectrogram")
        load_features = getattr(self.dataset, "load_features",
                                self.dataset.load_spectrogram)

        def load_s(loc):
            if loc not in s_cache:
                s_cache[loc] = load_features(loc)
            return s_cache[loc]

        targets = [load_t(loc) for loc in locators]
        rows = step_rows(rank, world, self.batch_size, self.accum_steps)[0]
        specs = [load_s(locators[i]) for i in rows]
        batch = {k: np.stack([t[k] for t in targets])
                 for k in ("time_sig", "key", "upper", "upper_lengths",
                           "lower", "lower_lengths")}
        if feature_key == "audio":
            # mixed int16/f32 clips normalize to f32 (see collate)
            from ..utils.audio import stack_audio_batch
            batch[feature_key] = stack_audio_batch(specs)
        else:
            batch[feature_key] = np.stack(specs)
        batch["names"] = [loc[1] for loc in locators]
        batch["versions"] = [loc[2] for loc in locators]
        batch["n_real"] = n_real
        batch["local_rows"] = rows
        return batch

    def _batches(self):
        for batch in self._raw_batches():
            if self.transform is not None:
                batch = self.transform(batch)
            yield batch

    def _raw_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start: start + self.batch_size]
            n_real = len(idxs)
            if self.shard is not None:
                yield self._sharded_batch(idxs, n_real)
                continue
            items = [self.dataset[int(i)] for i in idxs]
            if self.pad_final_batch and n_real < self.batch_size:
                items = items + [items[-1]] * (self.batch_size - n_real)
            batch = collate(items)
            batch["n_real"] = n_real
            yield batch

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def producer():
            try:
                for batch in self._batches():
                    # Bounded put + stop checks: if the consumer abandons
                    # the iterator (break / exception in the train loop),
                    # the generator's finally sets `stop` and this thread
                    # exits instead of blocking forever on a full queue
                    # pinning `prefetch` batches of host memory per
                    # abandoned epoch.
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                q.put(sentinel)
            except BaseException as exc:  # re-raised in the consumer
                if not stop.is_set():
                    q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is sentinel:
                    break
                if isinstance(batch, BaseException):
                    thread.join()
                    raise batch
                yield batch
            thread.join()
        finally:
            stop.set()
            while True:  # drain so a blocked put() wakes immediately
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5.0)
