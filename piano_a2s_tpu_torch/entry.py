"""A compile check of the port's greedy forward and a multi-rank dry run
of its training step: the twin of the JAX package's __graft_entry__.py.

    python -m piano_a2s_tpu_torch.entry [--device cpu]
    python -m piano_a2s_tpu_torch.entry multichip [N] [--device cpu]

The first builds the full-width model of random weights (seed 0), runs its
greedy forward once on one random spectrogram and prints the output
shapes; the second runs ``dryrun_multichip(N)`` (default 8): N gloo ranks,
each in its own process, through the data-parallel train and eval steps at
tiny shapes, on the card (ranks share the cards round-robin) or, with
``--device cpu``, on the CPU. Both default to the card and raise without
one.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from .models.convert import init_state_dict
from .models.score_transcription import ModelConfig, ScoreTranscription
from .utils.device import resolve_device, use_full_float32

FRAMES = 1201
DRYRUN_TIMEOUT_S = 300.0  # each rank's collectives


def entry(device="cuda", cfg: ModelConfig = None):
    """(fn, args): ``fn(*args)`` is the greedy forward of the model of
    ``cfg`` (default ``ModelConfig()``, full width) with weights from
    ``init_state_dict(cfg, 0)`` on ``device``, on one (1, 1, 1201,
    freq_bins) spectrogram from ``np.random.RandomState(0).randn``. It
    returns (time-signature log-probs, key log-probs, upper tokens, lower
    tokens)."""
    cfg = cfg or ModelConfig()
    dev = resolve_device(device)
    use_full_float32()
    model = ScoreTranscription(cfg)
    model.load_state_dict(init_state_dict(cfg, 0), strict=True)
    model.to(dev).eval()
    spec = torch.from_numpy(np.random.RandomState(0).randn(
        1, 1, FRAMES, cfg.freq_bins).astype(np.float32)).to(dev)

    def fn(model, spectrogram):
        ts, key, _, _, aux = model(spectrogram)
        return ts, key, aux["upper_tokens"], aux["lower_tokens"]

    return fn, (model, spec)


# The dry run's model and batch: __graft_entry__.py's tiny shapes, but the
# paper's encoder and hidden widths (256): on a card the float32 eval step
# runs the encoder's GRU through K4 and decodes greedily through K2, which
# are built for those widths alone.
DRYRUN_CFG = ModelConfig(freq_bins=16, conv_feature_size=256, hidden_size=256,
                         max_bars=2, max_length=(8, 6), note_emb_size=8,
                         staff_emb_size=8)
DRYRUN_FRAMES, DRYRUN_AUDIO_FRAMES = 24, 16


def _dryrun_batch(cfg: ModelConfig, b: int, hop_length: int) -> dict:
    """Random spectrograms, targets and int16 audio of b rows."""
    rng = np.random.RandomState(0)
    n_samples = (DRYRUN_AUDIO_FRAMES - 1) * hop_length
    return {
        "spectrogram": rng.randn(b, 1, DRYRUN_FRAMES,
                                 cfg.freq_bins).astype(np.float32),
        "time_sig": rng.randint(0, 7, (b, cfg.max_bars)),
        "key": rng.randint(0, 14, (b, cfg.max_bars)),
        "upper": rng.randint(0, 140, (b, cfg.max_bars, cfg.max_length[0])),
        "upper_lengths": np.full((b, cfg.max_bars), 4),
        "lower": rng.randint(0, 140, (b, cfg.max_bars, cfg.max_length[1])),
        "lower_lengths": np.full((b, cfg.max_bars), 3),
        "audio": np.clip(np.round(rng.randn(b, n_samples) * 3000), -32768,
                         32767).astype(np.int16),
    }


def _rank_device(rank: int, device: str) -> torch.device:
    """A dry-run rank's device: the CPU, or card ``rank`` modulo the cards
    there are (gloo lets several ranks share one)."""
    if resolve_device(device).type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _dryrun_rank(rank: int, world: int, init_file: str,
                 device: str = "cuda") -> None:
    """One rank of ``dryrun_multichip``: the data-parallel train step at
    accum_steps=2 (float32, then the bf16 ConvStack on uint8-staged
    spectrograms, then from int16 audio, then with guided attention) and
    the eval step, on ``_rank_device(rank, device)``; every loss must be
    finite."""
    from . import parallel
    from .ops.vqt import VQTConfig
    from .train.step import (duration_fraction_table, make_optimizer,
                             make_train_steps)

    torch.set_num_threads(1)
    dev = parallel.distributed_init(
        init_method=f"file://{init_file}", rank=rank, world_size=world,
        device=_rank_device(rank, device), backend="gloo",
        timeout_s=DRYRUN_TIMEOUT_S)
    try:
        group = torch.distributed.group.WORLD
        cfg = DRYRUN_CFG
        model = ScoreTranscription(cfg)
        model.load_state_dict(init_state_dict(cfg, 0), strict=True)
        model.to(dev)
        parallel.broadcast_module_(model, group=group)
        opt = make_optimizer(model.parameters(), lr=1.0)
        vcfg = VQTConfig(bins_per_octave=4, n_octaves=4)
        batch = _dryrun_batch(cfg, 2 * world, vcfg.hop_length)
        spec_batch = {k: v for k, v in batch.items() if k != "audio"}
        audio_batch = {k: v for k, v in batch.items() if k != "spectrogram"}

        def step(batch, seed, **kw):
            t_step, e_step = make_train_steps(opt, accum_steps=2,
                                              device=dev, group=group, **kw)
            out = t_step(model, batch,
                         torch.Generator(dev).manual_seed(seed), 0.7)
            if not bool(torch.isfinite(out.loss)):
                raise RuntimeError(f"rank {rank}: loss {float(out.loss)}")
            return out, e_step

        _, e_step = step(spec_batch, 0)
        out_eval, _ = e_step(model, spec_batch)
        if not bool(torch.isfinite(out_eval.loss)):
            raise RuntimeError(f"rank {rank}: eval loss "
                               f"{float(out_eval.loss)}")
        staged = dict(spec_batch, spectrogram=np.round(np.clip(
            spec_batch["spectrogram"], 0.0, 1.0) * 255.0).astype(np.uint8))
        step(staged, 1, conv_dtype=torch.bfloat16)
        audio_kw = dict(conv_dtype=torch.bfloat16, from_audio=True,
                        vqt_cfg=vcfg, max_frame_num=DRYRUN_AUDIO_FRAMES)
        step(audio_batch, 2, **audio_kw)
        # Half the rows carry the newline event separator and '<b>' chord
        # joins, so both sides of the guide's per-row map dispatch run.
        ga_batch = dict(audio_batch)
        b = len(ga_batch["time_sig"])
        for staff in ("upper", "lower"):
            toks = np.array(ga_batch[staff])
            toks[: b // 2, :, 2::4] = 143  # '\n'
            toks[: b // 2, :, 4::8] = 144  # '<b>'
            ga_batch[staff] = toks
        out_ga, _ = step(ga_batch, 3, ga_weight=2.0, ga_sigma=0.08,
                         ga_dur_frac=duration_fraction_table(cfg.vocab_size),
                         **audio_kw)
        if "ga_loss" not in out_ga.components:
            raise RuntimeError(f"rank {rank}: no ga_loss in "
                               f"{sorted(out_ga.components)}")
    finally:
        parallel.shutdown()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the data-parallel training step over ``n_devices`` gloo ranks,
    one process each, at tiny shapes and the paper's hidden size (batch
    2 n, accum_steps=2): float32 train and eval steps (the eval step's
    greedy decode through K2 on the card), the bf16 ConvStack on
    uint8-staged spectrograms, int16 audio through the VQT frontend (the
    VQT kernel on the card) and guided attention. ``device`` "cuda" puts
    rank r on card r modulo the cards there are (raises without one);
    "cpu" runs every rank on the CPU. Raises if a rank fails."""
    resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    try:
        torch.multiprocessing.spawn(
            _dryrun_rank,
            args=(n_devices, os.path.join(tmp, "init"), device),
            nprocs=n_devices, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if argv[:1] == ["multichip"]:
        n = int(argv[1]) if len(argv) > 1 else 8
        dryrun_multichip(n, device)
        print(f"dryrun_multichip({n}) on {device} OK")
        return 0
    fn, args = entry(device)
    with torch.inference_mode():
        outs = fn(*args)
    print("entry outputs:", [tuple(x.shape) for x in outs])
    return 0


if __name__ == "__main__":
    sys.exit(main())
