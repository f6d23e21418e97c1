"""Extension-dispatched load/save and small file helpers, a copy of
piano_a2s_tpu/utils/io.py (reference: utilities.py:27-58,203-226)."""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, List, Union

import numpy as np


def load(path: str) -> Any:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith((".yaml", ".yml")):
        import yaml
        with open(path) as f:
            return yaml.safe_load(f)
    if path.endswith(".csv"):
        import csv
        with open(path) as f:
            return list(csv.reader(f))
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return pickle.load(f)
    if path.endswith(".txt"):
        with open(path) as f:
            return [line.strip() for line in f]
    raise ValueError(f"unsupported extension: {path}")


def save(data: Any, path: str) -> None:
    if path.endswith(".npy"):
        np.save(path, np.asarray(data))
    elif path.endswith(".json"):
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
    elif path.endswith(".pkl"):
        with open(path, "wb") as f:
            pickle.dump(data, f)
    elif path.endswith((".yaml", ".yml")):
        import yaml
        with open(path, "w") as f:
            yaml.safe_dump(data, f)
    elif path.endswith(".txt"):
        with open(path, "w") as f:
            if isinstance(data, str):
                f.write(data)
            else:
                f.writelines(str(x) + "\n" for x in data)
    else:
        raise ValueError(f"unsupported extension: {path}")


def mkdirs(paths: Union[str, List[str]]) -> None:
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        os.makedirs(p, exist_ok=True)


def get_filename(path: str) -> str:
    """Stem of a path (reference: utilities.py:74-78)."""
    return os.path.splitext(os.path.basename(os.path.realpath(path)))[0]


def traverse_folder(folder: str):
    """All (names, paths) under a folder (reference: utilities.py:191-201)."""
    names, paths = [], []
    for root, _, files in os.walk(folder):
        for name in files:
            names.append(name)
            paths.append(os.path.join(root, name))
    return names, paths


def pad_truncate_sequence(x, max_len: int):
    """(reference: utilities.py:185-189)"""
    x = np.asarray(x)
    if len(x) < max_len:
        return np.concatenate((x, np.zeros(max_len - len(x))))
    return x[:max_len]


def append_to_dict(d: dict, key, value) -> None:
    """(reference: utilities.py:234-238)"""
    d.setdefault(key, []).append(value)


def read_maestro_metadata(csv_path: str) -> dict:
    """MAESTRO metadata csv reader (legacy parity; reference:
    utilities.py:104-140)."""
    import csv as _csv
    with open(csv_path) as f:
        lines = list(_csv.reader(f, delimiter=","))
    keys = ["canonical_composer", "canonical_title", "split", "year",
            "midi_filename", "audio_filename", "duration"]
    meta = {k: [] for k in keys}
    for row in lines[1:]:
        for i, k in enumerate(keys):
            meta[k].append(float(row[i]) if k == "duration" else row[i])
    return {k: np.array(v) for k, v in meta.items()}


def set_seed(seed: int) -> None:
    """Seed host-side RNGs (reference: utilities.py:228-232 seeds torch +
    numpy; JAX device randomness uses explicit PRNG keys instead)."""
    import random
    random.seed(seed)
    np.random.seed(seed)


def create_logging(log_dir: str, filemode: str = "w"):
    """File+console logging with auto-numbered log files (reference:
    utilities.py:80-102)."""
    import logging
    mkdirs(log_dir)
    i = 0
    while os.path.isfile(os.path.join(log_dir, f"{i:04d}.log")):
        i += 1
    logging.basicConfig(
        level=logging.DEBUG,
        format="%(asctime)s %(filename)s[line:%(lineno)d] %(levelname)s "
               "%(message)s",
        datefmt="%a, %d %b %Y %H:%M:%S",
        filename=os.path.join(log_dir, f"{i:04d}.log"),
        filemode=filemode)
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(
        logging.Formatter("%(name)-12s: %(levelname)-8s %(message)s"))
    logging.getLogger("").addHandler(console)
    return logging
