"""Experiment configs: plain YAML with ``<key>`` interpolation.

Copy of piano_a2s_tpu/config.py's loader (same key names and values as the
reference's hparams files, without HyperPyYAML's executable tags):

  - ``<key>`` placeholders (the reference's ``!ref`` forms rewritten as
    plain strings); a value that is a single reference keeps its type
  - overrides ``key=value`` (dotted paths allowed), applied before
    interpolation

``ExperimentConfig.model_config()`` and ``vqt_config()`` build the port's
own ``ModelConfig`` and ``VQTConfig``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import yaml

_PLACEHOLDER_RE = re.compile(r"<([A-Za-z0-9_]+)>")


def _interpolate(value: Any, root: Dict[str, Any], depth: int = 0) -> Any:
    # `depth` counts reference-resolution hops only (a <a> -> <b> -> ...
    # chain), not structural nesting.
    if depth > 10:
        raise ValueError("config interpolation too deep (cycle?)")
    if isinstance(value, str):
        whole = _PLACEHOLDER_RE.fullmatch(value)
        if whole:
            key = whole.group(1)
            if key not in root:
                raise KeyError(f"config reference <{key}> not found")
            return _interpolate(root[key], root, depth + 1)

        def sub(m):
            key = m.group(1)
            if key not in root:
                raise KeyError(f"config reference <{key}> not found")
            return str(_interpolate(root[key], root, depth + 1))
        return _PLACEHOLDER_RE.sub(sub, value)
    if isinstance(value, dict):
        return {k: _interpolate(v, root, depth) for k, v in value.items()}
    if isinstance(value, list):
        return [_interpolate(v, root, depth) for v in value]
    return value


def _coerce(text: str) -> Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def apply_overrides(cfg: Dict[str, Any], overrides: List[str]) -> None:
    """key=value / a.b=value overrides, applied before interpolation."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not key=value")
        key, val = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(
                    f"override '{ov}': '{p}' is not a mapping "
                    f"(cannot set nested key)")
        node[parts[-1]] = _coerce(val)


def load_config(path: str, overrides: Optional[List[str]] = None
                ) -> Dict[str, Any]:
    with open(path) as f:
        raw = yaml.safe_load(f)
    if overrides:
        apply_overrides(raw, overrides)
    return {k: _interpolate(v, raw) for k, v in raw.items()}


@dataclasses.dataclass
class ExperimentConfig:
    """Validated view over the YAML dict (reference key names preserved);
    keys that are not fields land in ``extras``."""
    seed: int = 1234
    midi_syn: str = "epr"
    workspace: str = ""
    output_folder: str = ""
    feature_folder: str = ""
    save_folder: str = ""
    train_log: str = ""

    sample_rate: int = 16000
    max_length: Tuple[int, int] = (398, 189)
    max_bars: int = 5
    num_time_sig: int = 7
    num_keys: int = 14
    max_duration: int = 12
    frames_per_second: int = 100
    max_frame_num: Optional[int] = None  # derived unless set explicitly
    hop_length: int = 160
    bins_per_octave: int = 60
    n_octaves: int = 8
    gamma: float = 20.0

    number_of_epochs: int = 30
    batch_size: int = 4
    lr: float = 1.0
    teacher_forcing_ratio: float = 0.7
    teacher_forcing_decay: float = 0.99
    ignore_index: int = 147

    conv_feature_size: int = 256
    hidden_size: int = 256
    note_emb_size: int = 16
    staff_emb_size: int = 32
    time_sig_emb_size: int = 5
    key_emb_size: int = 8

    # NewBob (reference: hparams/pretrain.yaml:104-108)
    improvement_threshold: float = 0.0025
    annealing_factor: float = 0.8
    patient: int = 0

    # finetune-only
    asap_folder: str = ""
    mv2h_bin: str = ""
    pretrained_output_folder: str = ""

    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.max_length = tuple(self.max_length)
        if self.max_frame_num is None:
            self.max_frame_num = int(self.max_duration
                                     * self.frames_per_second) + 1
        else:
            self.max_frame_num = int(self.max_frame_num)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        extras = {}
        for k, v in d.items():
            if k == "max_length" and isinstance(v, str):
                v = tuple(int(x) for x in re.findall(r"\d+", v))
            if k in field_names and k != "extras":
                kwargs[k] = v
            else:
                extras[k] = v
        out = cls(**kwargs)
        out.extras = extras
        return out

    def snapshot(self, folder: str) -> str:
        """Write the resolved config (fields and extras, overrides applied,
        references interpolated) to <folder>/hyperparams.yaml, so that every
        run folder records what it ran with."""
        d = dataclasses.asdict(self)
        d.update(d.pop("extras"))
        d["max_length"] = list(self.max_length)
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, "hyperparams.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)
        return path

    @property
    def max_samples(self) -> int:
        """Samples per clip of raw audio: what VQT turns into exactly
        max_frame_num frames."""
        return (self.max_frame_num - 1) * self.hop_length

    def dataset_kwargs(self) -> Dict[str, Any]:
        """The dataset constructors' keyword arguments that the training
        commands share: the shape caps and the configured feature mode."""
        return dict(
            max_frame_num=self.max_frame_num, max_length=self.max_length,
            input_features=self.extras.get("input_features", "spectrogram"),
            max_samples=self.max_samples)

    def model_config(self):
        from .models.score_transcription import ModelConfig
        return ModelConfig(
            freq_bins=self.bins_per_octave * self.n_octaves,
            conv_feature_size=self.conv_feature_size,
            hidden_size=self.hidden_size, max_bars=self.max_bars,
            num_time_sig=self.num_time_sig, num_keys=self.num_keys,
            max_length=tuple(self.max_length),
            note_emb_size=self.note_emb_size,
            staff_emb_size=self.staff_emb_size,
            time_sig_emb_size=self.time_sig_emb_size,
            key_emb_size=self.key_emb_size,
            # the loss-masked id is the vocabulary's <pad>
            pad=int(self.ignore_index))

    def vqt_config(self):
        from .ops.vqt import VQTConfig
        return VQTConfig(sample_rate=self.sample_rate,
                         hop_length=self.hop_length,
                         bins_per_octave=self.bins_per_octave,
                         n_octaves=self.n_octaves, gamma=self.gamma)


def load_experiment(path: str, overrides: Optional[List[str]] = None
                    ) -> ExperimentConfig:
    return ExperimentConfig.from_dict(load_config(path, overrides))


def load_configs(path: str):
    """(ModelConfig, VQTConfig, max_frame_num) of the experiment at path."""
    exp = load_experiment(path)
    return exp.model_config(), exp.vqt_config(), exp.max_frame_num
