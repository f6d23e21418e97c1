"""HTTP transcription server for the port (stdlib only).

The dynamic batcher (``TranscriptionService``) and the request handler
(``_Handler``) are the JAX package's, unchanged: they only call the
Transcriber's ``prepare_batch`` / ``transcribe_prepared`` and read its
``cfg``, ``vqt_cfg`` and ``max_samples``. This module adds the two pieces
that depend on the framework: building the server, and ``main``.

    python -m piano_a2s_tpu_torch.serve --port 8080
    curl -s --data-binary @clip.wav localhost:8080/transcribe
    curl -s --data-binary @clip.wav 'localhost:8080/transcribe?format=kern'
"""

from __future__ import annotations

from http.server import ThreadingHTTPServer

import numpy as np
import torch

from piano_a2s_tpu.serve import TranscriptionService, _Handler


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
                        help="torch checkpoint file (.ckpt/.pt/.pth; "
                             "default: random weights — smoke mode)")
    parser.add_argument("--config", default=None,
                        help="experiment YAML for model dims")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
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

    if args.config:
        from .config import load_configs
        cfg, vqt_cfg, max_frame_num = load_configs(args.config)
        tr = load_transcriber(args.checkpoint, cfg=cfg, vqt_cfg=vqt_cfg,
                              max_frame_num=max_frame_num,
                              device=args.device)
    else:
        tr = load_transcriber(args.checkpoint, device=args.device)
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
