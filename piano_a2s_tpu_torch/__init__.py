"""piano_a2s_tpu_torch — the PyTorch and CUDA port of piano_a2s_tpu.

Greedy audio-to-score inference, serving and the training step on an
NVIDIA GPU (Hopper):

- ``ops``: the VQT frontend (plain PyTorch, and a hand-written CUDA kernel
  under ``csrc/`` built with nvcc at first use), GRU, attention and layer
  helpers (BatchNorm fold and training-mode BatchNorm, dropout).
- ``models``: the ScoreTranscription model as ``nn.Module``s (greedy and
  teacher-forced forwards), and the weight converters.
- ``train``: the losses and the train/eval steps (Adadelta, clipping,
  gradient accumulation, the audio frontend inside the step), the Trainer,
  and the offline evaluation (the native MV2H and MUSTER scorers, host
  only).
- ``infer``, ``serve``, ``cli``: the Transcriber, the HTTP server and the
  commands (transcribe, pretrain, finetune, evaluate, prepare_data,
  import_checkpoint).
- ``symbolic``, ``data``, ``utils.audio``, ``config``: the host-side code
  the port uses (vocabulary, score export, WAV I/O, experiment configs),
  copied from the JAX package's modules of the same names.

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package ``piano_a2s_tpu``.
"""

__version__ = "0.1.0"
