"""The port's Transcriber against the JAX package's on the CPU: the same
clips give the same target structures, for float and int16 PCM input, the
stream equals the blocking calls, and results export to files."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax

from piano_a2s_tpu.infer import Transcriber as JaxTranscriber
from piano_a2s_tpu.models import ModelConfig, init_params, init_state
from piano_a2s_tpu.ops.vqt import VQTConfig
from piano_a2s_tpu_torch import infer as tinfer
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import state_dict_from_jax
from piano_a2s_tpu_torch.ops import vqt as tvqt
from piano_a2s_tpu_torch.ops.vqt_cuda import vqt_magnitude_cuda

torch.set_num_threads(2)

# tests/test_infer.py's configuration.
CFG = ModelConfig(freq_bins=12, conv_feature_size=16, hidden_size=16,
                  max_bars=2, max_length=(8, 6), note_emb_size=8,
                  staff_emb_size=8)
VQT = VQTConfig(bins_per_octave=3, n_octaves=4, window_size=1024,
                sample_rate=16000, hop_length=160)
TCFG = tst.ModelConfig(**{f: getattr(CFG, f) for f in
                          CFG.__dataclass_fields__})
TVQT = tvqt.VQTConfig(**{f: getattr(VQT, f) for f in
                         VQT.__dataclass_fields__})
FRAMES = 101


@pytest.fixture(scope="module")
def transcribers():
    params = init_params(jax.random.PRNGKey(0), CFG)
    params = jax.tree.map(np.array, params)
    for d in ("upper", "lower"):
        params["decoder"][d]["out"]["b"][CFG.eos] += 4.0
    state = jax.tree.map(np.asarray, init_state(CFG))
    jax_tr = JaxTranscriber(params, state, CFG, VQT, max_frame_num=FRAMES)
    port_tr = tinfer.Transcriber(state_dict_from_jax(params, state, TCFG),
                                 TCFG, TVQT, max_frame_num=FRAMES,
                                 device="cpu")
    return jax_tr, port_tr


def _clips(seed, lengths, int16=False):
    rng = np.random.RandomState(seed)
    if int16:
        return [rng.randint(-3000, 3000, n).astype(np.int16)
                for n in lengths]
    return [(0.1 * rng.randn(n)).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("int16", [False, True], ids=["float32", "int16"])
def test_same_targets_as_jax(transcribers, int16):
    jax_tr, port_tr = transcribers
    clips = _clips(1, (12000, 16000, 8000), int16)  # padded to a batch of 4
    assert port_tr.transcribe_batch(clips) == jax_tr.transcribe_batch(clips)
    assert port_tr.transcribe(clips[0]) == jax_tr.transcribe(clips[0])


def test_int16_equals_float(transcribers):
    _, port_tr = transcribers
    ints = _clips(4, (12000, 16000), int16=True)
    floats = [i.astype(np.float32) / 32768.0 for i in ints]
    assert port_tr.transcribe_batch(ints) == port_tr.transcribe_batch(floats)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_stream_equals_blocking(transcribers, depth):
    _, port_tr = transcribers
    clips = _clips(2, (12000, 16000, 8000, 16000, 5000))
    expected = [port_tr.transcribe(c) for c in clips]
    assert list(port_tr.transcribe_stream(clips, batch_size=2,
                                          depth=depth)) == expected


def test_interface_matches_jax(transcribers):
    jax_tr, port_tr = transcribers
    assert port_tr.max_samples == jax_tr.max_samples
    audio, n = port_tr.prepare_batch(_clips(3, (100, 200, 300)))
    assert n == 3 and audio.shape == (4, port_tr.max_samples)
    np.testing.assert_array_equal(audio[3], audio[2])
    timings = {}
    port_tr.transcribe_batch(_clips(3, (4000,)), timings=timings)
    assert set(timings) == {"host_prep_s", "device_s", "postprocess_s"}
    with pytest.raises(ValueError):
        port_tr.transcribe_stream([], batch_size=0)


def test_full_float32_flags_and_cpu_only_vqt(transcribers):
    _, port_tr = transcribers
    assert port_tr.device == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    before = vqt_magnitude_cuda.launches
    port_tr.transcribe(_clips(6, (8000,))[0])
    assert vqt_magnitude_cuda.launches == before


def test_result_to_files(transcribers, tmp_path):
    _, port_tr = transcribers
    result = port_tr.transcribe(_clips(0, (16000,))[0])
    assert len(result) == CFG.max_bars
    for key, ts, lower, upper in result:
        assert -6 <= key <= 7
        assert "/" in ts
        assert isinstance(lower, list) and isinstance(upper, list)
    paths = tinfer.result_to_files(result, str(tmp_path / "out"))
    assert os.path.exists(paths["kern"])
    assert open(paths["kern"]).read().startswith("!! upper staff")
    ET.parse(paths["musicxml"])
    assert open(paths["midi"], "rb").read()[:4] == b"MThd"


def test_load_transcriber(tmp_path):
    tr = tinfer.load_transcriber(None, TCFG, TVQT, seed=1,
                                 max_frame_num=FRAMES, device="cpu")
    path = str(tmp_path / "w.pt")
    torch.save(tr.model.state_dict(), path)
    again = tinfer.load_transcriber(path, TCFG, TVQT, max_frame_num=FRAMES,
                                    device="cpu")
    clip = _clips(5, (9000,))[0]
    assert again.transcribe(clip) == tr.transcribe(clip)
    with pytest.raises(ValueError, match="Orbax"):
        tinfer.load_transcriber(str(tmp_path), TCFG, TVQT, device="cpu")
