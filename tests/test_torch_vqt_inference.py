"""The VQT kernel's filter packing takes filters made under
``torch.inference_mode``: such tensors carry no version counter, which the
pack cache keys on (reading it raised), so they are packed on every call.
The packing is plain PyTorch and runs on the CPU."""

import torch

from piano_a2s_tpu_torch.ops import vqt as tvqt
from piano_a2s_tpu_torch.ops import vqt_cuda

CFG = tvqt.VQTConfig(bins_per_octave=3, n_octaves=4, window_size=1024,
                     sample_rate=16000, hop_length=160)


def test_inference_mode_filters_are_packed_each_call():
    with torch.inference_mode():
        cos_k, sin_k = tvqt.filters(CFG, "cpu")
    assert cos_k.is_inference()
    ref = vqt_cuda.pack_filters(cos_k, sin_k)
    for _ in range(2):
        got = vqt_cuda._packed(cos_k, sin_k)
        assert torch.equal(got, ref)
    assert got is not vqt_cuda._packed(cos_k, sin_k)
    with torch.inference_mode():
        cos_k.mul_(2.0)
        assert torch.equal(vqt_cuda._packed(cos_k, sin_k)[0, 0],
                           vqt_cuda.pack_filters(cos_k, sin_k)[0, 0])
