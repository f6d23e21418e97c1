"""HTTP transcription server for the port (stdlib only).

A threaded HTTP server whose handler threads feed a single device worker
through a dynamic batcher: requests arriving within a short window are
transcribed as one padded batch. The batcher (``TranscriptionService``),
the body decoding and rendering and the request handler are copies of
piano_a2s_tpu/serve.py's; they only call the Transcriber's
``prepare_batch`` / ``transcribe_prepared`` and read its ``cfg``,
``vqt_cfg`` and ``max_samples``.

    python -m piano_a2s_tpu_torch.serve --port 8080 [--bf16]
    curl -s --data-binary @clip.wav localhost:8080/transcribe
    curl -s --data-binary @clip.wav 'localhost:8080/transcribe?format=kern'

Endpoints:
  POST /transcribe[?format=json|kern|musicxml|midi]  body = WAV bytes
       (any sample rate/width/channels — decoded + resampled host-side)
       or a raw .npy mono float32/int16 array at the model sample rate.
  GET  /healthz   liveness + device/model info
  GET  /stats     request/batch counters
  GET  /          usage summary
"""

from __future__ import annotations

import io
import json
import os
import struct
import tempfile
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .symbolic.export import export_target, tokens_to_kern
from .utils.audio import read_wav, resample

# What a malformed request body raises while it is decoded: a 400.
_BAD_BODY = (ValueError, EOFError, OSError, wave.Error, struct.error)


class TranscriptionService:
    """Dynamic batcher in front of a Transcriber.

    Handler threads call submit(); a single worker thread drains the
    queue — it waits up to max_wait_ms after the first request for more
    to arrive (up to max_batch), then runs ONE transcribe_batch. One
    worker == one device stream: requests never contend for the card.
    """

    def __init__(self, transcriber, max_batch: int = 16,
                 max_wait_ms: float = 20.0,
                 fullness_target: float = 0.0,
                 fullness_extra_ms: float = 0.0):
        self.transcriber = transcriber
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        # Batch-fullness admission window: after max_wait expires, a batch
        # below fullness_target * max_batch clips may wait up to
        # fullness_extra_ms longer for the clients released by the
        # previous batch to resubmit. 0 disables.
        self.fullness_target = max(0.0, min(1.0, float(fullness_target)))
        self.fullness_extra = float(fullness_extra_ms) / 1e3
        self._lock = threading.Lock()
        self._queue: List[dict] = []
        self._wakeup = threading.Event()
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "clips": 0,
                      "errors": 0, "busy_s": 0.0, "max_batch_seen": 0,
                      # Per-phase profile of the worker's serial path:
                      # queue wait from a batch's first submit to its
                      # device call, then the Transcriber's host-prep /
                      # device / postprocess split.
                      "wait_s": 0.0, "host_prep_s": 0.0, "device_s": 0.0,
                      "postprocess_s": 0.0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, audio: np.ndarray, timeout: float = 120.0):
        """Blocking: enqueue one clip, wait for its transcription."""
        item = {"audio": audio, "done": threading.Event(),
                "result": None, "error": None, "t_submit": time.monotonic()}
        with self._lock:
            if self._closed:
                raise RuntimeError("service is shut down")
            self._queue.append(item)
            self.stats["requests"] += 1
        self._wakeup.set()
        if not item["done"].wait(timeout):
            # Mark the item so _take_batch drops it instead of spending a
            # device slot on a clip whose client already got an error.
            with self._lock:
                item["cancelled"] = True
            raise TimeoutError("transcription timed out")
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _take_batch(self) -> List[dict]:
        while True:
            self._wakeup.wait()
            with self._lock:
                if self._closed and not self._queue:
                    return []
                if not self._queue:
                    # Stale wakeup (the request already went into the
                    # previous batch): clear and block again, or an idle
                    # server would spin in the poll loop below.
                    self._wakeup.clear()
                    continue
            now = time.monotonic()
            deadline = now + self.max_wait
            # The admission window: a hard cap on how much longer an
            # under-full batch may wait after the base window.
            extended = deadline + self.fullness_extra
            need = int(self.fullness_target * self.max_batch)
            while True:
                with self._lock:
                    now = time.monotonic()
                    ready = (len(self._queue) >= self.max_batch
                             or self._closed
                             or (now >= deadline
                                 and (len(self._queue) >= need
                                      or now >= extended)))
                    if ready:
                        # Drop abandoned requests (submit() timeouts)
                        # before forming the batch.
                        if any(i.get("cancelled") for i in self._queue):
                            self._queue = [i for i in self._queue
                                           if not i.get("cancelled")]
                        batch = self._queue[: self.max_batch]
                        del self._queue[: len(batch)]
                        # Never clear after close(): its set() is the final
                        # signal, and clearing it would strand the worker's
                        # next wait() and hang close() on the join.
                        if not self._queue and not self._closed:
                            self._wakeup.clear()
                        return batch
                time.sleep(min(0.002, self.max_wait or 0.002))

    def snapshot(self) -> dict:
        with self._lock:
            stats = dict(self.stats)
        n = stats["batches"]
        stats["clips_per_batch"] = (round(stats["clips"] / n, 2)
                                    if n else 0.0)
        for k in ("wait_s", "host_prep_s", "device_s", "postprocess_s",
                  "busy_s"):
            stats[f"{k[:-2]}_ms_per_batch"] = (round(1e3 * stats[k] / n, 1)
                                               if n else 0.0)
        return stats

    def _run(self):
        # Serial: form batch -> host prep -> device.
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed:
                    return
                continue
            t0 = time.monotonic()
            wait = t0 - min(it["t_submit"] for it in batch)
            timings = {}
            try:
                specs, n = self.transcriber.prepare_batch(
                    [it["audio"] for it in batch])
                timings["host_prep_s"] = time.monotonic() - t0
                results = self.transcriber.transcribe_prepared(
                    specs, n, timings=timings)
                for it, res in zip(batch, results):
                    it["result"] = res
            except BaseException as exc:
                # The worker is the server's boundary: a failed batch fails
                # its requests and the worker goes on. Interrupts re-raise.
                for it in batch:
                    it["error"] = exc
                with self._lock:
                    self.stats["errors"] += len(batch)
                if not isinstance(exc, Exception):
                    raise
            finally:
                with self._lock:
                    self.stats["batches"] += 1
                    self.stats["clips"] += len(batch)
                    self.stats["busy_s"] += time.monotonic() - t0
                    self.stats["wait_s"] += wait
                    for k in ("host_prep_s", "device_s", "postprocess_s"):
                        self.stats[k] += timings.get(k, 0.0)
                    self.stats["max_batch_seen"] = max(
                        self.stats["max_batch_seen"], len(batch))
                for it in batch:
                    it["done"].set()

    def close(self):
        with self._lock:
            self._closed = True
        self._wakeup.set()
        self._worker.join(timeout=10)


def _decode_body(body: bytes, sample_rate: int) -> np.ndarray:
    """Request body -> mono clip at the model rate. WAV (any rate/width/
    channels) or .npy (1-D float/int16 at the model rate)."""
    if body[:6] == b"\x93NUMPY":
        audio = np.load(io.BytesIO(body), allow_pickle=False)
        if audio.ndim != 1 or not (np.issubdtype(audio.dtype, np.floating)
                                   or audio.dtype == np.int16):
            raise ValueError(
                f"expected a 1-D float or int16 PCM array at "
                f"{sample_rate} Hz, got {audio.dtype}{audio.shape}")
        return (audio if audio.dtype == np.int16
                else audio.astype(np.float32))
    if body[:4] != b"RIFF":
        raise ValueError("body is neither a WAV (RIFF) nor a .npy array")
    audio, sr = read_wav(io.BytesIO(body))
    return resample(audio, sr, sample_rate)


_RENDER_FORMATS = {"json", "kern", "musicxml", "midi"}


def _render(target, fmt: str):
    """Target structure -> (content_type, bytes) in the asked format."""
    if fmt in ("json", "kern"):
        kern_up = tokens_to_kern([m[3] for m in target])
        kern_low = tokens_to_kern([m[2] for m in target])
        if fmt == "json":
            bars = [{"key_signature": m[0], "time_signature": m[1],
                     "lower_tokens": m[2], "upper_tokens": m[3]}
                    for m in target]
            return "application/json", json.dumps(
                {"bars": bars,
                 "kern": {"upper": kern_up, "lower": kern_low}}).encode()
        text = ("!! upper staff\n" + kern_up
                + "\n!! lower staff\n" + kern_low + "\n")
        return "text/plain; charset=utf-8", text.encode()
    if fmt in ("musicxml", "midi"):
        suffix = ".xml" if fmt == "musicxml" else ".mid"
        fd, path = tempfile.mkstemp(suffix=suffix)
        os.close(fd)
        try:
            export_target(target,
                          musicxml_path=path if fmt == "musicxml" else None,
                          midi_path=path if fmt == "midi" else None)
            with open(path, "rb") as f:
                data = f.read()
        finally:
            os.unlink(path)
        ctype = ("application/vnd.recordare.musicxml+xml"
                 if fmt == "musicxml" else "audio/midi")
        return ctype, data
    raise ValueError(f"unknown format {fmt!r} "
                     "(json | kern | musicxml | midi)")


class _Handler(BaseHTTPRequestHandler):
    # set by make_server:
    service: TranscriptionService = None
    server_info: dict = {}
    log_requests = False

    def log_message(self, fmt, *args):  # quiet by default
        if self.log_requests:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _reply(self, code: int, ctype: str, data: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _reply_json(self, code: int, obj):
        self._reply(code, "application/json", json.dumps(obj).encode())

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/":
            self._reply_json(200, {
                "service": "piano_a2s_tpu_torch transcription",
                "usage": "POST /transcribe[?format=json|kern|musicxml|"
                         "midi] with a WAV or .npy body; "
                         "GET /healthz, /stats"})
        elif path == "/healthz":
            self._reply_json(200, {"status": "ok", **self.server_info})
        elif path == "/stats":
            self._reply_json(200, self.service.snapshot())
        else:
            self._reply_json(404, {"error": f"no route {path}"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path != "/transcribe":
            self._reply_json(404, {"error": f"no route {url.path}"})
            return
        fmt = parse_qs(url.query).get("format", ["json"])[0]
        if fmt not in _RENDER_FORMATS:
            # Reject before submit(): a typo'd format should not cost a
            # full device inference only to 400 at render time.
            self._reply_json(400, {"error": f"unknown format {fmt!r} "
                                            f"(one of {sorted(_RENDER_FORMATS)})"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if not 0 < length <= 512 * 2**20:
                raise ValueError("missing or oversized request body")
            body = self.rfile.read(length)
            sr = self.service.transcriber.vqt_cfg.sample_rate
            audio = _decode_body(body, sr)
        except _BAD_BODY as exc:
            # A corrupt upload is a property of the request, not of the
            # server: a 400, not a traceback and a dropped connection.
            self._reply_json(400, {"error": f"bad request body: {exc}"})
            return
        try:
            target = self.service.submit(audio)
            ctype, data = _render(target, fmt)
        except ValueError as exc:
            self._reply_json(400, {"error": str(exc)})
            return
        except BaseException as exc:
            # Surface the failure to the client; interrupts re-raise.
            self._reply_json(500, {"error": f"{type(exc).__name__}: {exc}"})
            if not isinstance(exc, Exception):
                raise
            return
        self._reply(200, ctype, data)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


class _Server(ThreadingHTTPServer):
    # The default listen backlog (5) drops connections under bursts of
    # concurrent clients, which the dynamic batcher exists to absorb.
    request_queue_size = 128


def make_server(transcriber, host: str = "127.0.0.1", port: int = 8080,
                max_batch: int = 16, max_wait_ms: float = 20.0,
                fullness_target: float = 0.0,
                fullness_extra_ms: float = 0.0,
                log_requests: bool = False) -> ThreadingHTTPServer:
    """Build (not start) the server; ``.service`` hangs off the instance.
    Call serve_forever() to run, shutdown() + service.close() to stop."""
    service = TranscriptionService(transcriber, max_batch=max_batch,
                                   max_wait_ms=max_wait_ms,
                                   fullness_target=fullness_target,
                                   fullness_extra_ms=fullness_extra_ms)
    cfg = transcriber.cfg

    class Handler(_Handler):
        pass

    Handler.service = service
    Handler.log_requests = log_requests
    Handler.server_info = {
        "device": device_name(transcriber.device),
        "sample_rate": transcriber.vqt_cfg.sample_rate,
        "max_seconds": transcriber.max_samples
        / transcriber.vqt_cfg.sample_rate,
        "model": {"hidden_size": cfg.hidden_size,
                  "max_bars": cfg.max_bars,
                  "vocab_size": cfg.vocab_size},
    }
    httpd = _Server((host, port), Handler)
    httpd.service = service
    return httpd


def warm(transcriber, max_batch: int) -> None:
    """Run every padded batch size up to max_batch once, in both wire
    dtypes (float32 and int16 PCM), before traffic arrives: the first call
    at each shape pays cuDNN's algorithm selection."""
    top = 1 << (max(1, max_batch) - 1).bit_length()
    for dt in (np.float32, np.int16):
        clip = np.zeros(transcriber.vqt_cfg.sample_rate, dt)
        b = 1
        while b <= top:
            print(f"warming batch size {b} ({np.dtype(dt).name}) ...",
                  flush=True)
            transcriber.transcribe_batch([clip] * b)
            b *= 2


def main(argv=None):
    import argparse

    from .infer import load_transcriber

    parser = argparse.ArgumentParser(
        description="HTTP transcription server (dynamic batching)")
    parser.add_argument("--checkpoint", default=None,
                        help="torch checkpoint file (.ckpt/.pt/.pth), "
                             "a save folder of the port's training "
                             "commands (its best checkpoint by WER) or "
                             "one CKPT+... directory of it ("
                             "default: random weights — smoke mode)")
    parser.add_argument("--config", default=None,
                        help="experiment YAML for model dims")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 conv stack and decode loop (the "
                             "softmaxes and log-probs stay float32)")
    parser.add_argument("--max-batch", type=int, default=16)
    parser.add_argument("--max-wait-ms", type=float, default=20.0,
                        help="batching window after the first request")
    parser.add_argument("--fullness-target", type=float, default=0.0,
                        help="fraction of max-batch an under-full batch "
                             "may keep waiting for after the base window "
                             "(0 disables the admission window)")
    parser.add_argument("--fullness-extra-ms", type=float, default=0.0,
                        help="hard cap on the ADDITIONAL wait an "
                             "under-full batch spends chasing "
                             "--fullness-target")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, cuda:N or cpu)")
    args = parser.parse_args(argv)

    decode_dtype = torch.bfloat16 if args.bf16 else None
    if args.config:
        from .config import load_configs
        cfg, vqt_cfg, max_frame_num = load_configs(args.config)
        tr = load_transcriber(args.checkpoint, cfg=cfg, vqt_cfg=vqt_cfg,
                              max_frame_num=max_frame_num,
                              device=args.device, decode_dtype=decode_dtype)
    else:
        tr = load_transcriber(args.checkpoint, device=args.device,
                              decode_dtype=decode_dtype)
    warm(tr, args.max_batch)

    httpd = make_server(tr, args.host, args.port,
                        max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        fullness_target=args.fullness_target,
                        fullness_extra_ms=args.fullness_extra_ms,
                        log_requests=True)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"({device_name(tr.device)}, max_batch={args.max_batch}, "
          f"wait={args.max_wait_ms}ms, fullness={args.fullness_target}"
          f"+{args.fullness_extra_ms}ms)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.service.close()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
