"""Host-side symbolic music: the token vocabulary and score export (kern
text, MusicXML, MIDI). Pure Python, copied from the JAX package's
``symbolic`` modules of the same names."""
