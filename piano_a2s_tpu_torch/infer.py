"""End-to-end inference: audio -> VQT -> model -> per-bar score structure.

Port of piano_a2s_tpu/infer.py. A clip of up to 12 s becomes the target
structure ``[[key, time_sig, lower_tokens, upper_tokens], ...]`` (one entry
per bar) ready for Kern/MusicXML/MIDI export. The audio goes to the device
as it is (float32, or int16 PCM converted there), the VQT frontend and the
model run on the device, and uint8 tokens and int16 lengths come back.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .data.datasets import load_time_signatures
from .models.convert import init_state_dict, load_torch_checkpoint
from .models.score_transcription import ModelConfig, ScoreTranscription
from .ops.vqt import VQTConfig, filters, get_vqt
from .symbolic.export import export_target, tokens_to_kern
from .train.checkpoint import Checkpointer, is_checkpoint
from .train.metrics import unpad
from .utils.audio import PCM16_SCALE, stack_audio_batch, trim_pad_audio
from .utils.device import resolve_device, use_full_float32


class Transcriber:
    """A model and its VQT filters on one device, for repeated calls.

    Float32 matmuls and cuDNN convolutions run without TF32, and bfloat16
    matmuls reduce in float32 (the process-wide flags are set here): the
    JAX package is the reference. Every tensor is created on
    ``self.device`` explicitly, so the server's worker thread can call in.

    ``decode_dtype`` None decodes in float32; torch.bfloat16 runs the
    ConvStack and the note decoders' loop in bfloat16, the softmaxes and
    the emitted log-probs in float32 (ScoreTranscription.forward). The
    weights stay float32; the bf16 copies are made per call.
    """

    def __init__(self, state_dict, cfg: ModelConfig = ModelConfig(),
                 vqt_cfg: VQTConfig = VQTConfig(),
                 max_frame_num: int = 1201, device="cuda",
                 decode_dtype: Optional[torch.dtype] = None):
        if decode_dtype not in (None, torch.bfloat16):
            raise ValueError(f"decode_dtype={decode_dtype}: supported "
                             "values are None (float32) and torch.bfloat16")
        self.device = resolve_device(device)
        use_full_float32()
        self.decode_dtype = decode_dtype
        self.cfg = cfg
        self.vqt_cfg = vqt_cfg
        self.max_frame_num = max_frame_num
        self.model = ScoreTranscription(cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(device=self.device, dtype=torch.float32).eval()
        self.kernels = filters(vqt_cfg, self.device)
        self.time_sig_list = load_time_signatures()

    @property
    def max_samples(self) -> int:
        return (self.max_frame_num - 1) * self.vqt_cfg.hop_length

    def _prep_audio(self, audio: np.ndarray) -> np.ndarray:
        """Mono audio -> fixed-length (max_samples,) float32, or int16 kept
        as it is (converted on the device)."""
        return trim_pad_audio(audio, self.max_samples)

    @torch.inference_mode()
    def _infer_audio(self, audio: np.ndarray):
        """(B, max_samples) float32 or int16 -> device tensors (time_sig,
        key, upper tokens, lower tokens as uint8; lengths as int16)."""
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)
        if x.dtype == torch.int16:
            x = x.to(torch.float32) / PCM16_SCALE
        spec = get_vqt(x, self.kernels, self.vqt_cfg)
        t = spec.shape[1]
        if t >= self.max_frame_num:
            spec = spec[:, : self.max_frame_num]
        else:
            spec = torch.nn.functional.pad(
                spec, (0, 0, 0, self.max_frame_num - t))
        ts, key, _, _, aux = self.model(spec[:, None],
                                        decode_dtype=self.decode_dtype)
        return (ts.argmax(-1).to(torch.uint8), key.argmax(-1).to(torch.uint8),
                aux["upper_tokens"].to(torch.uint8),
                aux["lower_tokens"].to(torch.uint8),
                aux["upper_lengths"].to(torch.int16),
                aux["lower_lengths"].to(torch.int16))

    @staticmethod
    def _to_host(arrays) -> tuple:
        return tuple(a.cpu().numpy() for a in arrays)

    # -- inference ----------------------------------------------------------

    def transcribe_batch(self, audio_batch: Sequence[np.ndarray],
                         timings: Optional[dict] = None
                         ) -> List[List[list]]:
        """List of mono clips -> list of per-clip target structures.

        ``timings`` (optional dict) accumulates seconds under
        "host_prep_s", "device_s" and "postprocess_s" (the server's /stats).
        """
        t0 = time.monotonic()
        audio, n = self.prepare_batch(audio_batch)
        if timings is not None:
            timings["host_prep_s"] = (timings.get("host_prep_s", 0.0)
                                      + time.monotonic() - t0)
        return self.transcribe_prepared(audio, n, timings=timings)

    def prepare_batch(self, audio_batch: Sequence[np.ndarray]):
        """Host half of transcribe_batch: trim/pad clips, stack, and pad the
        batch to the next power of two by repeating the last clip. Returns
        (audio, n); touches no device state."""
        audio = stack_audio_batch([self._prep_audio(a) for a in audio_batch])
        n = len(audio_batch)
        padded = max(1, 1 << (n - 1).bit_length())
        if padded != n:
            audio = np.concatenate(
                [audio, np.repeat(audio[-1:], padded - n, axis=0)])
        return audio, n

    def transcribe_prepared(self, audio, n: int,
                            timings: Optional[dict] = None
                            ) -> List[List[list]]:
        """Device half of transcribe_batch, then token decoding."""
        t1 = time.monotonic()
        arrays = self._to_host(self._infer_audio(audio))
        t2 = time.monotonic()
        out = self._postprocess(arrays, n)
        if timings is not None:
            t3 = time.monotonic()
            for k, v in (("device_s", t2 - t1), ("postprocess_s", t3 - t2)):
                timings[k] = timings.get(k, 0.0) + v
        return out

    def _postprocess(self, arrays, n: int) -> List[List[list]]:
        """Host outputs -> the first n clips' per-bar target structures."""
        ts, key, up, low, _, _ = arrays
        out = []
        for b in range(n):
            bars = []
            for m in range(self.cfg.max_bars):
                bars.append([
                    int(key[b, m]) - 6,
                    self.time_sig_list[int(ts[b, m])],
                    unpad(low[b, m]).tolist(),
                    unpad(up[b, m]).tolist(),
                ])
            out.append(bars)
        return out

    def transcribe(self, audio: np.ndarray) -> List[list]:
        return self.transcribe_batch([audio])[0]

    def transcribe_stream(self, clips: Iterable[np.ndarray],
                          batch_size: int = 16,
                          depth: int = 3) -> Iterator[List[list]]:
        """Yields each clip's target structure in input order, running
        fixed-size batches (the last padded by repeating its last clip).

        Up to ``depth`` finished batches wait on the device before their
        results are copied to the host and decoded. The decode loop reads
        its stop condition on the host every step, so batches do not
        overlap on the device yet; the results equal the blocking calls'.
        """
        if batch_size <= 0 or depth < 0:
            raise ValueError("batch_size must be >0 and depth >=0")
        return self._stream(clips, batch_size, depth)

    def _stream(self, clips, batch_size: int,
                depth: int) -> Iterator[List[list]]:
        inflight: deque = deque()

        def batches():
            buf: List[np.ndarray] = []
            for clip in clips:
                buf.append(self._prep_audio(clip))
                if len(buf) == batch_size:
                    yield buf, batch_size
                    buf = []
            if buf:
                n = len(buf)
                yield buf + [buf[-1]] * (batch_size - n), n

        for buf, n in batches():
            inflight.append((n, self._infer_audio(stack_audio_batch(buf))))
            if len(inflight) > depth:
                n0, arrs = inflight.popleft()
                yield from self._postprocess(self._to_host(arrs), n0)
        while inflight:
            n0, arrs = inflight.popleft()
            yield from self._postprocess(self._to_host(arrs), n0)


def load_transcriber(checkpoint: Optional[str] = None,
                     cfg: ModelConfig = ModelConfig(),
                     vqt_cfg: VQTConfig = VQTConfig(),
                     seed: int = 0, max_frame_num: int = 1201,
                     device="cuda",
                     decode_dtype: Optional[torch.dtype] = None
                     ) -> Transcriber:
    """A Transcriber from ``checkpoint``: a torch checkpoint file
    (.ckpt/.pt/.pth), a save folder of the port's training commands (its
    best checkpoint by WER), one ``CKPT+...`` directory of such a folder,
    or, with checkpoint=None, random weights drawn from ``seed``.
    ``decode_dtype``: see Transcriber."""
    if checkpoint is None:
        state_dict = init_state_dict(cfg, seed)
    elif os.path.isdir(checkpoint):
        state_dict = load_saved_model(checkpoint)
    elif checkpoint.endswith((".ckpt", ".pt", ".pth")):
        state_dict = load_torch_checkpoint(checkpoint)
    else:
        raise ValueError(
            f"{checkpoint!r}: the port loads torch checkpoint files "
            "(.ckpt/.pt/.pth) and the save folders of its own training "
            "commands")
    return Transcriber(state_dict, cfg, vqt_cfg, max_frame_num=max_frame_num,
                       device=device, decode_dtype=decode_dtype)


def load_saved_model(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of a port checkpoint directory (CKPT+...), or
    of the best checkpoint by WER in a save folder, on the CPU."""
    if not is_checkpoint(path):
        path = Checkpointer(path).best_path("WER") or path
    if not (is_checkpoint(path)
            and os.path.exists(os.path.join(path, "model.pt"))):
        raise ValueError(
            f"{path!r}: no checkpoint of the port here (a save folder of "
            "CKPT+*/ directories holding model.pt and meta.json, or one "
            "such directory). Orbax save folders, written by the JAX "
            "package, need jax to read; export one to a torch file with "
            "scripts/export_reference_checkpoint.py")
    trees, _, _ = Checkpointer(os.path.dirname(path)).load(path, ("model",))
    return trees["model"]


def result_to_files(target: List[list], out_prefix: str,
                    write_kern: bool = True, write_xml: bool = True,
                    write_mid: bool = True) -> Dict[str, str]:
    """Write {prefix}.krn/.xml/.mid from a target structure."""
    paths = {}
    if write_kern:
        kern_upper = tokens_to_kern([m[3] for m in target])
        kern_lower = tokens_to_kern([m[2] for m in target])
        paths["kern"] = f"{out_prefix}.krn"
        with open(paths["kern"], "w") as f:
            f.write("!! upper staff\n" + kern_upper
                    + "\n!! lower staff\n" + kern_lower + "\n")
    xml_path = f"{out_prefix}.xml" if write_xml else None
    mid_path = f"{out_prefix}.mid" if write_mid else None
    export_target(target, xml_path, mid_path)
    if xml_path:
        paths["musicxml"] = xml_path
    if mid_path:
        paths["midi"] = mid_path
    return paths
