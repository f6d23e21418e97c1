"""The ScoreTranscription model (inference half) and its weight loaders."""

from .convert import (init_state_dict, load_torch_checkpoint,
                      state_dict_from_jax)
from .score_transcription import ModelConfig, ScoreTranscription

__all__ = ["ModelConfig", "ScoreTranscription", "init_state_dict",
           "load_torch_checkpoint", "state_dict_from_jax"]
