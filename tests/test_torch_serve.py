"""The port's HTTP server on the CPU: health route and WAV transcription
through the JAX package's batcher and handler, with requests from several
client threads."""

import io
import json
import threading
import urllib.request
import wave

import numpy as np
import pytest
import torch

from piano_a2s_tpu_torch.infer import load_transcriber
from piano_a2s_tpu_torch.models import ModelConfig
from piano_a2s_tpu_torch.ops.vqt import VQTConfig
from piano_a2s_tpu_torch.serve import make_server

torch.set_num_threads(2)

VCFG = VQTConfig(bins_per_octave=4, n_octaves=4)
CFG = ModelConfig(freq_bins=16, conv_feature_size=24, hidden_size=16,
                  max_bars=2, max_length=(8, 6), note_emb_size=8,
                  staff_emb_size=8)


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2")
                      .tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def server():
    tr = load_transcriber(None, CFG, VCFG, seed=0, max_frame_num=20,
                          device="cpu")
    httpd = make_server(tr, "127.0.0.1", 0, max_batch=4, max_wait_ms=30)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.service.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    return urllib.request.urlopen(req, timeout=60)


def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=10) as r:
        assert r.status == 200
        info = json.load(r)
    assert info["status"] == "ok"
    assert info["device"] == "cpu"
    assert info["sample_rate"] == VCFG.sample_rate
    assert info["model"]["hidden_size"] == CFG.hidden_size


@pytest.mark.parametrize("fmt", ["json", "kern"])
def test_transcribe_wav(server, fmt):
    audio = 0.1 * np.random.RandomState(0).randn(3000)
    with _post(f"{server}/transcribe?format={fmt}",
               _wav_bytes(audio, 16000)) as r:
        assert r.status == 200
        body = r.read()
    assert body
    if fmt == "json":
        assert len(json.loads(body)["bars"]) == CFG.max_bars
    else:
        assert body.decode().startswith("!! upper staff")


def test_concurrent_requests_batch(server):
    results, errors = [], []

    def client(seed):
        try:
            audio = 0.1 * np.random.RandomState(seed).randn(2000)
            with _post(f"{server}/transcribe",
                       _wav_bytes(audio, 16000)) as r:
                results.append((r.status, json.load(r)))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert [s for s, _ in results] == [200] * 6
    with urllib.request.urlopen(f"{server}/stats", timeout=10) as r:
        stats = json.load(r)
    assert stats["clips"] >= 6 and stats["errors"] == 0
