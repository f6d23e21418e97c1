"""The port's model and VQT configs from an experiment YAML.

Reads only the fields of ``piano_a2s_tpu.config.ExperimentConfig``; its
``model_config()`` and ``vqt_config()`` methods build the JAX package's
classes and are not used here.
"""

from __future__ import annotations

from typing import Tuple

from piano_a2s_tpu.config import load_experiment

from .models.score_transcription import ModelConfig
from .ops.vqt import VQTConfig


def load_configs(path: str) -> Tuple[ModelConfig, VQTConfig, int]:
    """(ModelConfig, VQTConfig, max_frame_num) of the experiment at path."""
    exp = load_experiment(path)
    cfg = ModelConfig(
        freq_bins=exp.bins_per_octave * exp.n_octaves,
        conv_feature_size=exp.conv_feature_size,
        hidden_size=exp.hidden_size, max_bars=exp.max_bars,
        num_time_sig=exp.num_time_sig, num_keys=exp.num_keys,
        max_length=tuple(exp.max_length),
        note_emb_size=exp.note_emb_size,
        staff_emb_size=exp.staff_emb_size,
        time_sig_emb_size=exp.time_sig_emb_size,
        key_emb_size=exp.key_emb_size,
        pad=int(exp.ignore_index))
    vqt_cfg = VQTConfig(sample_rate=exp.sample_rate,
                        hop_length=exp.hop_length,
                        bins_per_octave=exp.bins_per_octave,
                        n_octaves=exp.n_octaves, gamma=exp.gamma)
    return cfg, vqt_cfg, exp.max_frame_num
