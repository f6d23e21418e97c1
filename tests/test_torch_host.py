"""The port's copies of the JAX package's host-side modules give the same
outputs as their originals on the same inputs: score export, WAV reading
and resampling, the vocabulary, the experiment configs, the time-signature
table, ``unpad``, and the HTTP server's answers."""

import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

import piano_a2s_tpu.config as jconfig
import piano_a2s_tpu.serve as jserve
import piano_a2s_tpu_torch.config as tconfig
import piano_a2s_tpu_torch.serve as tserve
from conftest import REPO_ROOT
from piano_a2s_tpu.data.datasets import load_time_signatures as j_time_sigs
from piano_a2s_tpu.symbolic import export as jexport
from piano_a2s_tpu.symbolic.vocab import LabelsMultiple as JLabels
from piano_a2s_tpu.train.metrics import unpad as j_unpad
from piano_a2s_tpu.utils import audio as jaudio
from piano_a2s_tpu_torch.data.datasets import \
    load_time_signatures as t_time_sigs
from piano_a2s_tpu_torch.models import ModelConfig
from piano_a2s_tpu_torch.ops.vqt import VQTConfig
from piano_a2s_tpu_torch.symbolic import export as texport
from piano_a2s_tpu_torch.symbolic.vocab import LabelsMultiple as TLabels
from piano_a2s_tpu_torch.train.metrics import unpad as t_unpad
from piano_a2s_tpu_torch.utils import audio as taudio

_LABELS = JLabels(extended=True)
MEASURES = ["4c 4e 4g\t2C", "[4cc\t8D\n8E]\t4FF#\n8dd-;\t8r", "2.a\t2AA",
            "16b\t16G\n16cc#\t16G\n8r\t8BB-"]


def _target():
    """A 4-bar target [[key, time_sig, lower_tokens, upper_tokens], ...]
    built from kern text through the vocabulary."""
    tokens = [_LABELS.encode(m) for m in MEASURES]
    return [[k - 2, ts, tokens[(i + 1) % 4], tokens[i]]
            for i, (k, ts) in enumerate(zip(range(4),
                                            ("4/4", "3/4", "4/4", "6/8")))]


def _wav(audio, sr=16000, width=2, channels=1) -> bytes:
    buf = io.BytesIO()
    pcm = np.clip(np.asarray(audio, np.float64), -1, 1)
    if channels > 1:
        pcm = np.stack([pcm, -pcm], axis=1).reshape(-1)
    if width == 1:
        raw = (pcm * 127 + 128).astype(np.uint8).tobytes()
    elif width == 2:
        raw = (pcm * 32767).astype("<i2").tobytes()
    elif width == 3:
        v = (pcm * (2**23 - 1)).astype("<i4")
        raw = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255],
                       axis=1).astype(np.uint8).tobytes()
    else:
        raw = (pcm * (2**31 - 1)).astype("<i4").tobytes()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)
    return buf.getvalue()


# --- symbolic ------------------------------------------------------------------

def test_labels_multiple_maps_equal():
    for extended in (False, True):
        j, t = JLabels(extended), TLabels(extended)
        assert t.labels == j.labels
        assert t.labels_map == j.labels_map
        assert t.labels_map_inv == j.labels_map_inv
        assert (t.sos, t.eos, t.pad) == (j.sos, j.eos, j.pad)
    t = TLabels(extended=True)
    for m in MEASURES:
        assert t.encode(m) == _LABELS.encode(m)
        assert t.decode(t.encode(m)) == _LABELS.decode(_LABELS.encode(m))
    with pytest.raises(ValueError):
        t.encode("4x")


def test_tokens_to_kern_equal():
    target = _target()
    for staff in (2, 3):
        measures = [m[staff] for m in target]
        assert texport.tokens_to_kern(measures) == \
            jexport.tokens_to_kern(measures)
    rng = np.random.RandomState(0)
    noisy = [rng.randint(0, 173, 20).tolist() for _ in range(3)]
    assert texport.tokens_to_kern(noisy) == jexport.tokens_to_kern(noisy)


@pytest.mark.parametrize("fmt", ["musicxml", "midi"])
def test_export_target_bytes_equal(tmp_path, fmt):
    out = {}
    for name, mod in (("jax", jexport), ("port", texport)):
        path = str(tmp_path / f"{name}.{fmt}")
        mod.export_target(_target(),
                          musicxml_path=path if fmt == "musicxml" else None,
                          midi_path=path if fmt == "midi" else None)
        with open(path, "rb") as f:
            out[name] = f.read()
    assert out["port"] and out["port"] == out["jax"]


# --- audio ---------------------------------------------------------------------

@pytest.mark.parametrize("width,channels,sr", [
    (2, 1, 16000), (2, 2, 44100), (3, 1, 22050), (1, 1, 8000),
    (4, 2, 16000)])
def test_read_wav_equal(tmp_path, width, channels, sr):
    audio = 0.5 * np.sin(np.linspace(0, 300, 4001))
    body = _wav(audio, sr, width, channels)
    got, got_sr = taudio.read_wav(io.BytesIO(body))
    ref, ref_sr = jaudio.read_wav(io.BytesIO(body))
    assert got_sr == ref_sr == sr and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    path = str(tmp_path / "x.wav")
    with open(path, "wb") as f:
        f.write(body)
    for expect in (None, 16000):
        got = taudio.read_wav_pcm16(path, expect_sr=expect)
        ref = jaudio.read_wav_pcm16(path, expect_sr=expect)
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(got[0], ref[0])
            assert got[1] == ref[1]
    data = jaudio.read_wav(path)[0]
    np.testing.assert_array_equal(taudio.resample(data, sr, 16000),
                                  jaudio.resample(data, sr, 16000))


def test_audio_batch_helpers_equal():
    rng = np.random.RandomState(1)
    f32 = rng.randn(500).astype(np.float32) * 0.3
    i16 = jaudio.to_pcm16(f32)
    for clip in (f32, i16, f32[:300], i16[:300]):
        for n in (400, 500, 600):
            np.testing.assert_array_equal(taudio.trim_pad_audio(clip, n),
                                          jaudio.trim_pad_audio(clip, n))
    clips = [jaudio.trim_pad_audio(c, 450) for c in (f32, i16, f32)]
    got = taudio.stack_audio_batch(clips)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jaudio.stack_audio_batch(clips))
    assert taudio.PCM16_SCALE == jaudio.PCM16_SCALE


# --- data, metrics, config -----------------------------------------------------

def test_time_signatures_and_unpad_equal():
    assert t_time_sigs() == j_time_sigs()
    eos = _LABELS.eos
    for seq in ([1, 2, eos, 4, eos], [5, 6, 7], [eos], []):
        a = np.asarray(seq, np.int64)
        np.testing.assert_array_equal(t_unpad(a), j_unpad(a))


@pytest.mark.parametrize("name", ["pretrain", "finetune"])
def test_load_experiment_equal(name):
    path = f"{REPO_ROOT}/configs/{name}.yaml"
    overrides = ["batch_size=8", "lr=0.5", "extras_probe=3",
                 "teacher_forcing_ratio=0.6"]
    for ov in (None, overrides):
        ref = jconfig.load_experiment(path, ov)
        got = tconfig.load_experiment(path, ov)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.max_samples == ref.max_samples
        assert dataclasses.asdict(got.model_config()) == \
            dataclasses.asdict(ref.model_config())
        jv, tv = dataclasses.asdict(ref.vqt_config()), \
            dataclasses.asdict(got.vqt_config())
        assert {k: tv[k] for k in jv} == jv
    assert got.batch_size == 8 and got.extras["extras_probe"] == 3
    cfg, vqt_cfg, frames = tconfig.load_configs(path)
    assert isinstance(cfg, ModelConfig) and isinstance(vqt_cfg, VQTConfig)
    assert frames == ref.max_frame_num


def test_config_interpolation_equal(tmp_path):
    path = tmp_path / "x.yaml"
    path.write_text("root: /data\nsub: <root>/feat\nn: 3\nm: <n>\n"
                    "nested: {a: [<root>, 1]}\n")
    assert tconfig.load_config(str(path)) == jconfig.load_config(str(path))
    assert tconfig.load_config(str(path))["m"] == 3
    path.write_text("a: <b>\nb: <a>\n")
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError):
            mod.load_config(str(path))


# --- the server --------------------------------------------------------------

class _StubTranscriber:
    """What the servers read of a Transcriber, answering every clip with
    the same target."""

    cfg = ModelConfig(hidden_size=16, max_bars=4)
    vqt_cfg = VQTConfig()
    max_samples = 16000
    device = torch.device("cpu")

    def prepare_batch(self, clips):
        return list(clips), len(clips)

    def transcribe_prepared(self, audio, n, timings=None):
        return [_target() for _ in range(n)]


@pytest.fixture(scope="module")
def servers():
    urls, stop = {}, []
    for name, mod in (("jax", jserve), ("port", tserve)):
        httpd = mod.make_server(_StubTranscriber(), "127.0.0.1", 0,
                                max_batch=4, max_wait_ms=5)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        urls[name] = f"http://127.0.0.1:{httpd.server_address[1]}"
        stop.append((httpd, thread))
    yield urls
    for httpd, thread in stop:
        httpd.shutdown()
        httpd.service.close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _npy(array) -> bytes:
    buf = io.BytesIO()
    np.save(buf, array)
    return buf.getvalue()


_WAV = _wav(0.2 * np.sin(np.linspace(0, 100, 3000)))
REQUESTS = {
    "wav_json": ("POST", "/transcribe", _WAV),
    "wav_kern": ("POST", "/transcribe?format=kern", _WAV),
    "wav_musicxml": ("POST", "/transcribe?format=musicxml", _WAV),
    "wav_midi": ("POST", "/transcribe?format=midi", _WAV),
    "wav_44k": ("POST", "/transcribe",
                _wav(0.2 * np.sin(np.linspace(0, 100, 4000)), 44100)),
    "npy_f32": ("POST", "/transcribe",
                _npy(np.zeros(2000, np.float32))),
    "npy_i16": ("POST", "/transcribe?format=kern",
                _npy(np.zeros(2000, np.int16))),
    "npy_2d": ("POST", "/transcribe", _npy(np.zeros((2, 20), np.float32))),
    "corrupt_wav": ("POST", "/transcribe", b"RIFF" + b"\x00" * 40),
    "junk_body": ("POST", "/transcribe", b"hello"),
    "bad_format": ("POST", "/transcribe?format=pdf", _WAV),
    "no_route": ("POST", "/elsewhere", _WAV),
    "get_root": ("GET", "/", None),
    "get_missing": ("GET", "/nope", None),
}


def _call(url, method, path, body):
    req = urllib.request.Request(url + path, data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers["Content-Type"], err.read()


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_server_answers_equal(servers, case):
    method, path, body = REQUESTS[case]
    got = _call(servers["port"], method, path, body)
    ref = _call(servers["jax"], method, path, body)
    assert got[0] == ref[0], (case, got, ref)
    assert got[1] == ref[1]
    if got[0] == 200 and case != "get_root":
        assert got[2] == ref[2]
    if case in ("corrupt_wav", "junk_body", "bad_format", "npy_2d"):
        assert got[0] == 400 and "error" in json.loads(got[2])


def test_server_health_and_stats(servers):
    for name in ("port", "jax"):
        status, _, body = _call(servers[name], "GET", "/healthz", None)
        info = json.loads(body)
        assert status == 200 and info["status"] == "ok"
        assert info["model"]["max_bars"] == 4
        status, _, body = _call(servers[name], "GET", "/stats", None)
        assert status == 200 and "clips_per_batch" in json.loads(body)
