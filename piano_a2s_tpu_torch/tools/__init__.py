"""Diagnostic tools of the port, each a module that runs as
``python -m piano_a2s_tpu_torch.tools.<name>`` (``main(argv=None)``):

- ``frontend_ab``: decoding from stored spectrograms against decoding from
  audio through the device VQT (token, key, time-signature and WER
  agreement);
- ``inspect_attention``: the note decoder's attention for one bar
  (entropy, argmax frame, the guided-attention expected frame,
  teacher-forced accuracy);
- ``load_test``: a closed-loop HTTP load test of the server.

They run on the card by default (``--device cuda``) and on the CPU only
when asked (``--device cpu``). Importing a tool does no work.
"""
