"""End-to-end inference: audio -> VQT -> model -> per-bar score structure.

Port of piano_a2s_tpu/infer.py. A clip of up to 12 s becomes the target
structure ``[[key, time_sig, lower_tokens, upper_tokens], ...]`` (one entry
per bar) ready for Kern/MusicXML/MIDI export. The audio goes to the device
as it is (float32, or int16 PCM converted there), the VQT frontend and the
model run on the device, and uint8 tokens and int16 lengths come back. A
stored spectrogram decodes through the same model
(``Transcriber._infer_spectrogram``), and ``Transcriber.spectrogram`` gives
the model's input for a clip.

Multi-device serving (``Transcriber(use_mesh=True)``, the JAX package's
batch-sharded mesh): one model copy and one VQT filter pair per device,
the batch cut into contiguous equal shards, each shard's whole forward on
its own device, one shard after another. The shards share nothing and stop
their decodes each on its own, as the JAX package's shard_map does; on a
model that is sure of its EOS the results equal one device's.

Stop groups (``decode_chunk``, default "auto" as in the JAX package): a
batch above 16 clips (32 under bfloat16) decodes in groups of that many
clips (a divisor of the batch; ``pick_decode_chunk``), each with its own
batch-coupled early exit, in one loop. On a model that is not sure of its
EOS a clip's tokens depend on its stop group's mates, as they depend on
its batch's; batches of 16 or fewer are one group.
"""

from __future__ import annotations

import os
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
from .utils.profiling import span


class Transcriber:
    """A model and its VQT filters on one device, for repeated calls.

    Float32 matmuls and cuDNN convolutions run without TF32, and bfloat16
    matmuls reduce in float32 (the process-wide flags are set here): the
    JAX package is the reference. Every tensor is created on
    ``self.device`` explicitly, so the server's worker thread can call in.
    On a card one Transcriber serves one thread at a time: its model's
    captured note decode (``models/score_transcription.py::_NoteDecode``)
    keeps one set of buffers per shape, which a second thread's call would
    overwrite. On the CPU calls from several threads are safe.

    ``decode_dtype`` None decodes in float32; torch.bfloat16 runs the
    ConvStack and the note decoders' loop in bfloat16, the softmaxes and
    the emitted log-probs in float32 (ScoreTranscription.forward). The
    weights stay float32; the bf16 copies are made per call.

    ``use_mesh=True`` shards every batch over ``devices`` (default: every
    visible CUDA device; without one it raises, and the CPU is used only
    as ``devices=["cpu"] * k``). A device may repeat: ``["cuda:0",
    "cuda:0"]`` runs two shards on one card. Batches are padded to a
    multiple of the device count.

    ``decode_chunk`` (None, an int or "auto"): the decode's stop groups
    (see the module docstring), picked against each shard's own rows on
    the mesh; None decodes every batch as one group.
    """

    def __init__(self, state_dict, cfg: ModelConfig = ModelConfig(),
                 vqt_cfg: VQTConfig = VQTConfig(),
                 max_frame_num: int = 1201, device="cuda",
                 decode_dtype: Optional[torch.dtype] = None,
                 use_mesh: bool = False, devices=None, decode_chunk="auto"):
        if decode_dtype not in (None, torch.bfloat16):
            raise ValueError(f"decode_dtype={decode_dtype}: supported "
                             "values are None (float32) and torch.bfloat16")
        if use_mesh:
            if devices is None:
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "use_mesh=True shards over the visible CUDA devices "
                        "and there is none (pass devices=['cpu'] * k to "
                        "shard on the CPU)")
                devices = [f"cuda:{i}"
                           for i in range(torch.cuda.device_count())]
            devices = [resolve_device(d) for d in devices]
        elif devices is not None:
            raise ValueError("devices= shards a batch: it needs "
                             "use_mesh=True")
        else:
            devices = [resolve_device(device)]
        self.mesh = use_mesh
        self.devices = devices
        use_full_float32()
        self.decode_dtype = decode_dtype
        self.decode_chunk = decode_chunk
        self.cfg = cfg
        self.vqt_cfg = vqt_cfg
        self.max_frame_num = max_frame_num
        # One model copy and filter pair per shard.
        self._shards = []
        for dev in devices:
            model = ScoreTranscription(cfg)
            model.load_state_dict(state_dict, strict=True)
            model.to(device=dev, dtype=torch.float32).eval()
            self._shards.append((model, filters(vqt_cfg, dev)))
        self.device = devices[0]
        self.model, self.kernels = self._shards[0]
        self.time_sig_list = load_time_signatures()

    @property
    def max_samples(self) -> int:
        return (self.max_frame_num - 1) * self.vqt_cfg.hop_length

    def _prep_audio(self, audio: np.ndarray) -> np.ndarray:
        """Mono audio -> fixed-length (max_samples,) float32, or int16 kept
        as it is (converted on the device)."""
        return trim_pad_audio(audio, self.max_samples)

    def _vqt(self, audio: np.ndarray, shard: int = 0) -> torch.Tensor:
        """(B, samples) float32 or int16 (divided by PCM16_SCALE on the
        device) -> the log-VQT (B, frames, bins) on ``shard``'s device."""
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(
            self.devices[shard])
        if x.dtype == torch.int16:
            x = x.to(torch.float32) / PCM16_SCALE
        return get_vqt(x, self._shards[shard][1], self.vqt_cfg)

    def _frontend(self, audio: np.ndarray, shard: int = 0) -> torch.Tensor:
        """(B, max_samples) audio -> the model's input (B, 1,
        max_frame_num, bins): the log-VQT cut or zero-padded on the
        device to max_frame_num frames."""
        spec = self._vqt(audio, shard)
        t = spec.shape[1]
        if t >= self.max_frame_num:
            spec = spec[:, : self.max_frame_num]
        else:
            spec = torch.nn.functional.pad(
                spec, (0, 0, 0, self.max_frame_num - t))
        return spec[:, None]

    @torch.inference_mode()
    def _infer_spectrogram(self, spec, shard: int = 0):
        """(B, 1, max_frame_num, bins) float32 spectrogram (numpy or
        tensor) -> device tensors (time_sig, key, upper tokens, lower
        tokens as uint8; lengths as int16), on ``shard``'s device and
        model."""
        spec = torch.as_tensor(spec, dtype=torch.float32).to(
            self.devices[shard])
        ts, key, _, _, aux = self._shards[shard][0](
            spec, decode_dtype=self.decode_dtype,
            decode_chunk=self.decode_chunk)
        return (ts.argmax(-1).to(torch.uint8), key.argmax(-1).to(torch.uint8),
                aux["upper_tokens"].to(torch.uint8),
                aux["lower_tokens"].to(torch.uint8),
                aux["upper_lengths"].to(torch.int16),
                aux["lower_lengths"].to(torch.int16))

    @torch.inference_mode()
    def _infer_audio(self, audio: np.ndarray, shard: int = 0):
        """(B, max_samples) float32 or int16 -> ``_infer_spectrogram``'s
        outputs, through the device frontend."""
        return self._infer_spectrogram(self._frontend(audio, shard), shard)

    @torch.inference_mode()
    def spectrogram(self, audio: np.ndarray) -> np.ndarray:
        """Mono audio (at most max_samples are kept) -> the model's input
        spectrogram (1, max_frame_num, bins) float32 on the host: the clip
        trimmed or zero-padded to max_samples, its log-VQT on the device,
        the frames zero-padded on the host. For inspecting the input; the
        inference paths run the frontend on the device."""
        spec = self._vqt(self._prep_audio(audio)[None])[0].cpu().numpy()
        out = np.zeros((self.max_frame_num, spec.shape[-1]), np.float32)
        out[: spec.shape[0]] = spec[: self.max_frame_num]
        return out[None]

    def _infer_sharded(self, audio: np.ndarray) -> tuple:
        """The mesh's forward: contiguous equal shards of the batch, each
        through ``_infer_audio`` on its device, one after another; the host
        arrays joined in order. The decode loop waits on the host every
        step, so the shards do not overlap; host threads, one a shard, were
        slower still (PERF.md, mesh serving)."""
        parts = np.split(audio, len(self._shards))
        results = [self._to_host(self._infer_audio(p, i))
                   for i, p in enumerate(parts)]
        return tuple(np.concatenate(a) for a in zip(*results))

    def _launch(self, audio: np.ndarray) -> tuple:
        """One batch's outputs: device tensors on one device, host arrays
        from the mesh."""
        return (self._infer_sharded(audio) if self.mesh
                else self._infer_audio(audio))

    @staticmethod
    def _to_host(arrays) -> tuple:
        return tuple(a if isinstance(a, np.ndarray) else a.cpu().numpy()
                     for a in arrays)

    # -- inference ----------------------------------------------------------

    def transcribe_batch(self, audio_batch: Sequence[np.ndarray],
                         timings: Optional[dict] = None
                         ) -> List[List[list]]:
        """List of mono clips -> list of per-clip target structures.

        ``timings`` (optional dict) accumulates seconds under
        "host_prep_s", "device_s" and "postprocess_s" (the server's /stats):
        the walls of the spans ``transcribe/prepare``, ``/device`` and
        ``/postprocess``. ``device_s`` is the host's wall around the launch
        and the copy back, not device time.
        """
        with span("transcribe/prepare", into=timings, key="host_prep_s",
                  ranged=False):
            audio, n = self.prepare_batch(audio_batch)
        return self.transcribe_prepared(audio, n, timings=timings)

    def prepare_batch(self, audio_batch: Sequence[np.ndarray]):
        """Host half of transcribe_batch: trim/pad clips, stack, and pad the
        batch to the next power of two (on the mesh, then up to a multiple
        of the device count) by repeating the last clip. Returns (audio,
        n); touches no device state."""
        audio = stack_audio_batch([self._prep_audio(a) for a in audio_batch])
        n = len(audio_batch)
        padded = max(1, 1 << (n - 1).bit_length())
        if self.mesh:
            k = len(self.devices)
            padded = -(-max(padded, k) // k) * k
        if padded != n:
            audio = np.concatenate(
                [audio, np.repeat(audio[-1:], padded - n, axis=0)])
        return audio, n

    def transcribe_prepared(self, audio, n: int,
                            timings: Optional[dict] = None
                            ) -> List[List[list]]:
        """Device half of transcribe_batch, then token decoding; ``timings``
        as there ("device_s" and "postprocess_s")."""
        with span("transcribe/device", into=timings, key="device_s",
                  ranged=False):
            arrays = self._to_host(self._launch(audio))
        with span("transcribe/postprocess", into=timings,
                  key="postprocess_s", ranged=False):
            return self._postprocess(arrays, n)

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
        On the mesh the device count must divide ``batch_size`` (checked
        here, at the call).
        """
        if batch_size <= 0 or depth < 0:
            raise ValueError("batch_size must be >0 and depth >=0")
        if self.mesh and batch_size % len(self.devices):
            raise ValueError(f"batch_size={batch_size} must divide the "
                             f"{len(self.devices)}-device mesh")
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
            inflight.append((n, self._launch(stack_audio_batch(buf))))
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
                     decode_dtype: Optional[torch.dtype] = None,
                     decode_chunk="auto") -> Transcriber:
    """A Transcriber from ``checkpoint``: a torch checkpoint file
    (.ckpt/.pt/.pth), a save folder of the port's training commands (its
    best checkpoint by WER), one ``CKPT+...`` directory of such a folder,
    or, with checkpoint=None, random weights drawn from ``seed``.
    ``decode_dtype``, ``decode_chunk``: see Transcriber."""
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
                       device=device, decode_dtype=decode_dtype,
                       decode_chunk=decode_chunk)


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
            "scripts/export_reference_checkpoint.py (a save folder of the "
            "port exports to the reference format with python -m "
            "piano_a2s_tpu_torch.cli.export_checkpoint)")
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
