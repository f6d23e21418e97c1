"""piano_a2s_tpu_torch — the PyTorch and CUDA port of piano_a2s_tpu.

Greedy audio-to-score inference and serving on an NVIDIA GPU (Hopper):

- ``ops``: the VQT frontend (plain PyTorch, and a hand-written CUDA kernel
  under ``csrc/`` built with nvcc at first use), GRU, attention and layer
  helpers.
- ``models``: the ScoreTranscription model's inference half as
  ``nn.Module``s, and the weight converters.
- ``infer``, ``serve``, ``cli``: the Transcriber, the HTTP server and the
  transcribe command.

The package imports ``torch`` and never ``jax``; it reuses the JAX
package's framework-free host modules (audio I/O, vocabulary, export).
"""

__version__ = "0.1.0"
