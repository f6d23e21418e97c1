"""Cross-cutting utilities, as piano_a2s_tpu/utils re-exports them
(reference: utilities.py); device selection is in ``utils.device``."""

from .io import load, mkdirs, save, set_seed  # noqa: F401
from .audio import (  # noqa: F401
    float32_to_int16, int16_to_float32, read_wav, resample, write_wav)
from .sequences import get_sequence_duration  # noqa: F401
