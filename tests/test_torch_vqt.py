"""The port's VQT frontend against the JAX package: the filterbank builder
bit for bit, the plain magnitude against the XLA path and the Pallas kernel
(interpret mode), float64 against the numpy twin, and the per-clip log
compression. The CUDA kernel itself runs only on a GPU; its filter packing,
its split-TF32 arithmetic (emulated) and its build cache are tested here."""

import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from piano_a2s_tpu.ops import vqt as jvqt
from piano_a2s_tpu.ops.vqt_pallas import vqt_magnitude_pallas
from piano_a2s_tpu_torch.ops import _build
from piano_a2s_tpu_torch.ops import vqt as tvqt
from piano_a2s_tpu_torch.ops import vqt_cuda
from piano_a2s_tpu_torch.ops.vqt_cuda import vqt_magnitude_cuda

torch.set_num_threads(2)

CFG = tvqt.VQTConfig()
JCFG = jvqt.VQTConfig()
SMALL = dict(bins_per_octave=3, n_octaves=4, window_size=1024)
# The kernel's error against float64 may be at most this multiple of the
# plain f32 version's, on the magnitude and after log_compress.
F64_RATIO = 2.0


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
                                  "hop", "shape", "noncontiguous",
                                  "filters_mismatch", "no_bins"])
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
    elif case == "filters_mismatch":
        sin_k = sin_k[:, :-1]
    elif case == "no_bins":
        cos_k, sin_k = cos_k[:, :0], sin_k[:, :0]
    with pytest.raises((ValueError, TypeError)):
        vqt_magnitude_cuda(y, cos_k, sin_k, w, hop)
    assert vqt_magnitude_cuda.launches == 0


def _errors_f64(mag, ref64):
    """Max |mag - ref64| on the magnitude and after log_compress, both in
    float64."""
    m = mag.double()
    return ((m - ref64).abs().max().item(),
            (tvqt.log_compress(m) - tvqt.log_compress(ref64)).abs().max()
            .item())


@pytest.mark.parametrize("kw", [{}, SMALL], ids=["default", "small"])
def test_pack_filters_layout(kw):
    """Row 2f is cos and row 2f+1 sin of bin f, taps contiguous; rows past
    2 * n_bins are zero up to the tile width; hi is a TF32 value and
    hi + lo rebuilds the filters within 2^-22 relative."""
    cfg = tvqt.VQTConfig(**kw)
    cos_k, sin_k = tvqt.filters(cfg, "cpu")
    packed = vqt_cuda.pack_filters(cos_k, sin_k)
    n_cols = -(-2 * cfg.n_bins // vqt_cuda.TILE_COLS) * vqt_cuda.TILE_COLS
    assert packed.shape == (2, n_cols, cfg.window_size)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    hi, lo = packed
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert not packed[:, 2 * cfg.n_bins:].any()
    whole = (hi.double() + lo.double())[:2 * cfg.n_bins]
    for rows, ref in ((whole[0::2], cos_k), (whole[1::2], sin_k)):
        ref = ref.T.double()
        assert ((rows - ref).abs() <= 2.0 ** -22 * ref.abs()).all()


def test_round_tf32_is_nearest_ties_away():
    """round_tf32 rounds to 10 mantissa bits like cvt.rna.tf32.f32: to the
    nearest, halfway cases away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 2,
                      1 + ulp / 2 - 2 ** -23, 0.0, -0.0])
    assert vqt_cuda.round_tf32(x).tolist() == [1 + ulp, -(1 + ulp),
                                               1 + 2 * ulp, 1.0, 0.0, 0.0]


def test_packed_filters_cached_per_pair():
    """The filters are packed once per filter pair, not per call, and packed
    again after an in-place write."""
    cos_k, sin_k = tvqt.filters(CFG, "cpu")
    first = vqt_cuda._packed(cos_k, sin_k)
    assert vqt_cuda._packed(cos_k, sin_k) is first
    assert vqt_cuda._packed(cos_k, sin_k.clone()) is not first
    again = vqt_cuda._packed(cos_k, sin_k)
    cos_k.mul_(2.0)
    repacked = vqt_cuda._packed(cos_k, sin_k)
    assert repacked is not again
    torch.testing.assert_close(repacked[0, 0], 2.0 * again[0, 0])


def _split_tf32_magnitude(y, products):
    """Emulates the kernel's arithmetic on one clip: the TF32 parts of the
    frames times the packed filters, the given (A part, B part) products
    (0 = hi, 1 = lo) summed exactly within each 32-tap chunk and the chunk
    sums added in float32."""
    w, hop = CFG.window_size, CFG.hop_length
    frames = F.pad(torch.from_numpy(y), (w // 2, w // 2)) \
        .unfold(-1, w, hop)[:tvqt.num_frames(len(y), CFG)]
    a = vqt_cuda.split_tf32(frames)
    b = vqt_cuda.pack_filters(*tvqt.filters(CFG, "cpu")).double()
    acc = torch.zeros(frames.shape[0], b.shape[1])
    for k in range(0, w, vqt_cuda.KC):
        taps = slice(k, k + vqt_cuda.KC)
        acc += sum(a[i][:, taps].double() @ b[j][:, taps].T
                   for i, j in products).float()
    acc = acc[:, :2 * CFG.n_bins].double()
    return torch.sqrt(acc[:, 0::2] ** 2 + acc[:, 1::2] ** 2)


def test_split_tf32_as_accurate_as_f32_one_tf32_pass_not():
    """On one full 12 s clip, against the float64 host twin: the kernel's
    three-product split-TF32 arithmetic is within F64_RATIO x the plain f32
    product's error, on the magnitude and after log_compress; one TF32 pass
    (hi * hi alone) misses that bound by 10x or more."""
    y = (0.1 * np.random.RandomState(1).randn(192000)).astype(np.float32)
    ref64 = torch.from_numpy(jvqt.vqt_host(y, JCFG))
    plain = _errors_f64(tvqt.vqt_magnitude_torch(
        torch.from_numpy(y), tvqt.filters(CFG, "cpu"), CFG), ref64)
    split = _errors_f64(_split_tf32_magnitude(
        y, ((0, 0), (0, 1), (1, 0))), ref64)
    one_pass = _errors_f64(_split_tf32_magnitude(y, ((0, 0),)), ref64)
    for m in range(2):
        assert split[m] <= F64_RATIO * plain[m]
        assert one_pass[m] >= 10 * F64_RATIO * plain[m]


def test_build_digest_covers_every_csrc_file_and_flag(tmp_path, monkeypatch):
    """The library's name hashes every file under csrc/ and the flags: an
    unchanged tree reuses the built library, an edited header rebuilds."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    (csrc / "common.cuh").write_text("#define TILE 1\n")
    build_dir = tmp_path / "build"
    build_dir.mkdir()
    digest = _build.source_digest(str(csrc))
    assert digest == _build.source_digest(str(csrc))
    lib = build_dir / f"libvqt_mag_{digest}.so"
    lib.write_bytes(b"")

    def no_nvcc():
        raise RuntimeError("rebuild")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    built = _build.build("vqt_mag", str(build_dir), str(csrc))
    assert built.path == str(lib) and built.seconds == 0.0
    (csrc / "common.cuh").write_text("#define TILE 2\n")
    assert _build.source_digest(str(csrc)) != digest
    with pytest.raises(RuntimeError, match="rebuild"):
        _build.build("vqt_mag", str(build_dir), str(csrc))
    (csrc / "common.cuh").write_text("#define TILE 1\n")
    assert _build.source_digest(str(csrc)) == digest
    monkeypatch.setattr(_build, "NVCC_LIBS", _build.NVCC_LIBS + ("-lm",))
    assert _build.source_digest(str(csrc)) != digest


@pytest.mark.cuda
@pytest.mark.parametrize("shape,amp,seed", [((2, 48000), 0.2, 0),
                                            ((16, 192000), 0.1, 1),
                                            ((3, 16037), 0.2, 2)],
                         ids=["batched", "16_clips_12s", "ragged"])
def test_kernel_matches_plain_on_gpu(cuda_device, shape, amp, seed):
    """The kernel against the plain version in float64: at most F64_RATIO x
    the plain f32 version's error, and within 1e-4 of it."""
    y = torch.tensor(
        (amp * np.random.RandomState(seed).randn(*shape)).astype(np.float32),
        device=cuda_device)
    kernels = tvqt.filters(CFG, cuda_device)
    before = vqt_magnitude_cuda.launches
    got = tvqt.vqt_magnitude(y, kernels, CFG)
    ref = tvqt.vqt_magnitude_torch(y, kernels, CFG)
    ref64 = tvqt.vqt_magnitude_torch(
        y.double(), tvqt.filters(CFG, cuda_device, torch.float64), CFG)
    torch.cuda.synchronize()
    assert vqt_magnitude_cuda.launches == before + 1
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() < 1e-4
    kernel_err, plain_err = _errors_f64(got, ref64), _errors_f64(ref, ref64)
    for m in range(2):
        assert kernel_err[m] <= F64_RATIO * plain_err[m]
