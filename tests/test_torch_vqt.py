"""The port's VQT frontend against the JAX package: the filterbank builder
bit for bit, the plain magnitude against the XLA path and the Pallas kernel
(interpret mode), float64 against the numpy twin, and the per-clip log
compression. The CUDA kernel itself runs only on a GPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from piano_a2s_tpu.ops import vqt as jvqt
from piano_a2s_tpu.ops.vqt_pallas import vqt_magnitude_pallas
from piano_a2s_tpu_torch.ops import vqt as tvqt
from piano_a2s_tpu_torch.ops.vqt_cuda import vqt_magnitude_cuda

torch.set_num_threads(2)

CFG = tvqt.VQTConfig()
JCFG = jvqt.VQTConfig()
SMALL = dict(bins_per_octave=3, n_octaves=4, window_size=1024)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kw", [{}, SMALL], ids=["default", "small"])
def test_build_kernels_bit_exact(kw):
    got = tvqt.build_kernels(tvqt.VQTConfig(**kw))
    ref = jvqt.build_kernels(jvqt.VQTConfig(**kw))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(tvqt.filter_lengths(tvqt.VQTConfig(**kw)),
                                  jvqt.filter_lengths(jvqt.VQTConfig(**kw)))
    assert tvqt.num_frames(192000, CFG) == jvqt.num_frames(192000, JCFG)


@pytest.mark.parametrize("shape,amp,seed", [((2, 48000), 0.2, 0),
                                            ((1, 192000), 0.1, 1)],
                         ids=["batched", "one_12s_clip"])
def test_plain_magnitude_matches_xla_and_pallas(shape, amp, seed):
    y = (amp * np.random.RandomState(seed).randn(*shape)).astype(np.float32)
    kernels = tuple(map(jnp.asarray, jvqt.build_kernels(JCFG)))
    ref = np.asarray(jvqt.vqt_magnitude(y, kernels, JCFG))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(vqt_magnitude_pallas(y, kernels, JCFG))
    got = tvqt.vqt_magnitude(torch.from_numpy(y),
                             tvqt.filters(CFG, "cpu"), CFG).numpy()
    assert got.shape == ref.shape == (shape[0], 1 + shape[1] // 160, 480)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got, pallas, atol=1e-4)


def test_plain_magnitude_float64_matches_host_twin():
    y = 0.2 * np.random.RandomState(2).randn(16037)  # ragged hop tail
    got = tvqt.vqt_magnitude_torch(
        torch.from_numpy(y), tvqt.filters(CFG, "cpu", torch.float64), CFG)
    np.testing.assert_allclose(got.numpy(), jvqt.vqt_host(y, JCFG),
                               atol=1e-9)


def test_log_compress_per_clip_reference():
    """Clips 100x apart in amplitude each normalise to their own max: a
    max over the batch would push the quiet clip down by 40 dB."""
    rng = np.random.RandomState(3)
    mag = np.abs(rng.randn(2, 50, 24)).astype(np.float32) + 1e-3
    mag[1] = 100.0 * mag[0]
    ref = np.asarray(jvqt.log_compress(jnp.asarray(mag)))
    got = tvqt.log_compress(torch.from_numpy(mag)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got[0], got[1], atol=1e-5)
    assert got.max(axis=(1, 2)).tolist() == [1.0, 1.0]


def test_get_vqt_matches_jax():
    y = (0.1 * np.random.RandomState(4).randn(2, 16000)).astype(np.float32)
    y[1] *= 0.01
    ref = np.asarray(jvqt.get_vqt(y, cfg=JCFG))
    got = tvqt.get_vqt(torch.from_numpy(y), cfg=CFG).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_cpu_tensor_never_launches_kernel(monkeypatch):
    monkeypatch.setattr(vqt_magnitude_cuda, "launches", 0)
    y = torch.from_numpy(
        (0.1 * np.random.RandomState(5).randn(1, 4000)).astype(np.float32))
    tvqt.get_vqt(y, cfg=CFG)
    assert vqt_magnitude_cuda.launches == 0


@pytest.mark.parametrize("case", ["cpu_tensor", "float64", "window",
                                  "hop", "shape", "noncontiguous"])
def test_kernel_wrapper_rejects(case, monkeypatch):
    """The kernel's wrapper raises on every input it does not take, a CPU
    tensor included: it never falls back to the plain version."""
    monkeypatch.setattr(vqt_magnitude_cuda, "launches", 0)
    cos_k, sin_k = tvqt.filters(CFG, "cpu")
    y = torch.zeros(2, 1600)
    w, hop = CFG.window_size, CFG.hop_length
    if case == "float64":
        y = y.double()
    elif case == "window":
        w = 1100
    elif case == "hop":
        hop, w = 140, 1120
    elif case == "shape":
        y = y[0]
    elif case == "noncontiguous":
        y = torch.zeros(1600, 2).T
    with pytest.raises((ValueError, TypeError)):
        vqt_magnitude_cuda(y, cos_k, sin_k, w, hop)
    assert vqt_magnitude_cuda.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,amp,seed", [((2, 48000), 0.2, 0),
                                            ((16, 192000), 0.1, 1)],
                         ids=["batched", "16_clips_12s"])
def test_kernel_matches_plain_on_gpu(cuda_device, shape, amp, seed):
    y = torch.tensor(
        (amp * np.random.RandomState(seed).randn(*shape)).astype(np.float32),
        device=cuda_device)
    kernels = tvqt.filters(CFG, cuda_device)
    before = vqt_magnitude_cuda.launches
    got = tvqt.vqt_magnitude(y, kernels, CFG)
    ref = tvqt.vqt_magnitude_torch(y, kernels, CFG)
    torch.cuda.synchronize()
    assert vqt_magnitude_cuda.launches == before + 1
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() < 1e-4
    assert (tvqt.log_compress(got) - tvqt.log_compress(ref)).abs().max() \
        .item() < 1e-5
