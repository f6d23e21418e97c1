"""The feature pass of the offline data preparation, without jax.

Usage:
    python -m piano_a2s_tpu_torch.cli.prepare_data syn configs/pretrain.yaml \
        [spectrograms] [key=value ...]
    python -m piano_a2s_tpu_torch.cli.prepare_data asap configs/finetune.yaml \
        [spectrograms] [key=value ...]

The last stage of the JAX package's prepare_data.py: every WAV of the
feature folder becomes a log-VQT spectrogram/ .npy and a model-rate int16
audio/ .npy, written with the port's host VQT twin (the same files as the
JAX package's). ``syn`` walks {train,valid,test}/{version}/wav/ for the
versions 0..train_versions-1, in groups of two versions over a pool of up
to five processes, as the JAX package does; ``asap`` walks
{train,test}/wav/. The stages that make the WAVs (convert, preprocess,
split, midi, clean, render; for ASAP the score and audio slicing) run on
the host with external tools and stay with the JAX package: this command
refuses them and names the command that runs them.
"""

import argparse
import multiprocessing
import sys
from functools import partial

from piano_a2s_tpu_torch.config import load_experiment
from piano_a2s_tpu_torch.data import asap, render

# The JAX package's syn stages, in order; the port runs only the last.
ALL_STAGES = ["convert", "preprocess", "split", "midi", "clean", "render",
              "spectrograms"]
PORTED = "spectrograms"


def run_syn(exp) -> int:
    versions = list(range(int(exp.extras.get("train_versions", 10))))
    if not versions:
        print("train_versions is 0 — nothing to do")
        return 0
    version_groups = [versions[i:i + 2] for i in range(0, len(versions), 2)]
    pool_size = max(1, min(5, len(version_groups)))
    print("Preparing spectrograms...")
    work = partial(render.prepare_spectrograms,
                   feature_folder=exp.feature_folder,
                   sample_rate=exp.sample_rate,
                   max_duration=exp.max_duration)
    with multiprocessing.get_context("spawn").Pool(pool_size) as pool:
        return sum(pool.map(work, version_groups))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dataset", choices=["syn", "asap"])
    parser.add_argument("hparams")
    parser.add_argument("stages", nargs="*", default=[],
                        help=f"'{PORTED}' (the default); key=value args are "
                             "config overrides")
    args = parser.parse_args(argv)

    overrides = [s for s in args.stages if "=" in s]
    stages = [s for s in args.stages if "=" not in s] or [PORTED]
    syn = args.dataset == "syn"
    unknown = [s for s in stages if syn and s not in ALL_STAGES]
    if unknown:
        parser.error(f"unknown stage(s) {unknown}; valid: {ALL_STAGES}")
    host_tools = [s for s in stages if s != PORTED]
    if host_tools:
        # The JAX package's asap command takes no stages: it runs them all.
        jax_cmd = (f"python prepare_data.py {args.dataset} {args.hparams}"
                   + (f" {' '.join(host_tools)}" if syn else ""))
        parser.error(
            f"stage(s) {host_tools} run on the host with external tools "
            "(verovio, FluidSynth, virtuosoNet) and are not ported; run them "
            f"with the JAX package's command: {jax_cmd}")

    exp = load_experiment(args.hparams, overrides)
    if args.dataset == "syn":
        n = run_syn(exp)
    else:
        n = asap.prepare_spectrograms(exp.feature_folder, exp.sample_rate,
                                      exp.max_duration)
    print(f"wrote {n} spectrograms under {exp.feature_folder}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
