"""Host-side symbolic music: the token vocabulary, the kern tokenizer and
kern tools (native, with Python twins), and score export (kern text,
MusicXML, MIDI), copied from the JAX package's
``symbolic`` modules of the same names."""

from .vocab import Labels, LabelsMultiple, LabelsSingle  # noqa: F401
