#!/usr/bin/env python3
"""Closed-loop HTTP load test for the transcription server.

A copy of scripts/load_test.py (numpy and the standard library only). N
concurrent clients each own a slice of the clip pool and re-submit as soon
as their previous request returns (closed-loop: the client population
bounds the number of in-flight clips, which is exactly the regime where
batch fullness matters — see DESIGN §12/§12d). Prints one JSON line:
end-to-end clips/s, error count, and the server's /stats (clips per batch,
per-phase ms). /stats counters accumulate since server start — use a fresh
server per measured config.

Usage:
  python -m piano_a2s_tpu_torch.tools.load_test \
      [--url http://127.0.0.1:8000] [--clients 64] [--clips 256] \
      [--seconds 12] [--seed 0] [--audio-dir DIR]

Start the server first, e.g.:
  python -m piano_a2s_tpu_torch.serve --port 8000 --max-batch 32 \
      --device cuda [--bf16] [--checkpoint ...] \
      [--fullness-target 0.75 --fullness-extra-ms 150]
"""
import argparse
import io
import json
import struct
import sys
import threading
import time
import urllib.request

import numpy as np


def wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    """Minimal 16-bit PCM WAV writer (no external deps)."""
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(data)))
    buf.write(b"WAVEfmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(data)))
    buf.write(data)
    return buf.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://127.0.0.1:8000")
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--clips", type=int, default=256)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--audio-dir", default=None,
                    help="pool of .npy audio clips (e.g. a synth corpus "
                         "audio/ folder) instead of random noise")
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    if args.audio_dir:
        import os
        files = sorted(os.listdir(args.audio_dir))[:args.clips]
        pool = [np.load(f"{args.audio_dir}/{f}").astype(np.float32)
                for f in files]
    else:
        pool = [(0.2 * rng.randn(int(args.seconds * args.sr)))
                .astype(np.float32) for _ in range(min(args.clips, 32))]
    bodies = [wav_bytes(a, args.sr) for a in pool]

    ok, errors = 0, 0
    lock = threading.Lock()
    work = list(range(args.clips))

    def client():
        nonlocal ok, errors
        while True:
            with lock:
                if not work:
                    return
                i = work.pop()
            req = urllib.request.Request(
                f"{args.url}/transcribe?format=json",
                data=bodies[i % len(bodies)],
                headers={"Content-Type": "audio/wav"})
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    json.loads(r.read())
                with lock:
                    ok += 1
            except BaseException as exc:
                # A failed request counts as an error; interrupts re-raise.
                if not isinstance(exc, Exception):
                    raise
                with lock:
                    errors += 1

    threads = [threading.Thread(target=client) for _ in range(args.clients)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0

    stats = {}
    try:
        with urllib.request.urlopen(f"{args.url}/stats", timeout=10) as r:
            stats = json.loads(r.read())
    except BaseException as exc:
        if not isinstance(exc, Exception):
            raise
    print(json.dumps({
        "clients": args.clients, "clips": args.clips,
        "ok": ok, "errors": errors,
        "wall_s": round(wall, 1),
        "clips_per_sec": round(ok / wall, 2),
        "server_stats": stats,
    }))
    return 0 if errors == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
