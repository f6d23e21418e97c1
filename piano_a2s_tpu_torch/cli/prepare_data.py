"""Offline dataset preparation (synthesis + ASAP preprocessing), without jax.

Usage:
    python -m piano_a2s_tpu_torch.cli.prepare_data syn configs/pretrain.yaml \
        [stages...] [key=value ...] [--kern-folder DIR] [--xml-folder DIR]
    python -m piano_a2s_tpu_torch.cli.prepare_data asap configs/finetune.yaml \
        [key=value ...]

The JAX package's prepare_data.py on the port's copies of its stages: for
the same inputs and tools it writes the same files. Stages for ``syn``
(default: all): convert, preprocess, split, midi, clean, render,
spectrograms. External tools are needed only by the stages that use them:
verovio by convert and by score-MIDI rendering (midi_syn=score), hum2xml
and verovio by preprocess for Joplin scores, FluidSynth and the soundfonts
by render, a virtuosoNet checkout by midi_syn=epr with
epr_engine=virtuosonet (epr_engine=native renders without any tool; auto
takes virtuosoNet where a checkout is found). split, clean and
spectrograms need none. ``split``, ``render`` and ``spectrograms`` fan the
versions 0..train_versions-1 out in groups of two over a pool of up to
five processes, as the JAX package does, but spawned rather than forked (a
forked child of a process that has initialized CUDA is unsafe). ``asap``
runs ProcessASAP.process_all: verovio score conversion, annotation
matching, audio slicing, targets and the feature pass.
"""

import argparse
import multiprocessing
import os
import sys
from functools import partial

from piano_a2s_tpu_torch.config import load_experiment

ALL_STAGES = ["convert", "preprocess", "split", "midi", "clean", "render",
              "spectrograms"]


def _pool_map(work, version_groups):
    pool_size = max(1, min(5, len(version_groups)))
    with multiprocessing.get_context("spawn").Pool(pool_size) as pool:
        return pool.map(work, version_groups)


def make_epr_generate(exp):
    """The ``epr_generate(xml_path, composer) -> midi_path`` of
    ``epr_engine``: virtuosoNet when selected or (auto) when a checkout is
    found, else the native rule-based renderer."""
    # Engine selection mirrors the MV2H/MUSTER pattern: the external tool
    # (virtuosoNet) is canonical when present; the native rule-based
    # renderer covers tool-free hosts.
    #   auto (default): virtuosoNet if a checkout is found, else native
    #     with a notice;  virtuosonet: fail fast if absent;
    #   native: always the in-repo engine.
    from piano_a2s_tpu_torch.data.epr import (find_virtuosonet,
                                              make_epr_generator)
    engine = str(exp.extras.get("epr_engine", "auto"))
    if engine not in ("auto", "virtuosonet", "native"):
        raise SystemExit(f"epr_engine={engine!r}: expected "
                         "auto|virtuosonet|native")
    vnet = None
    if engine in ("auto", "virtuosonet"):
        vnet = find_virtuosonet(exp.extras.get("virtuosonet_path"),
                                workspace=exp.workspace)
    if engine == "virtuosonet" or (engine == "auto" and vnet):
        # The found checkout is the explicit root, so the generator binds
        # to exactly the checkout announced here. vnet None here means
        # engine=virtuosonet with nothing found: make_epr_generator fails
        # fast with install instructions.
        generate = make_epr_generator(
            vnet or exp.extras.get("virtuosonet_path"),
            workspace=exp.workspace)
        print(f"EPR engine: virtuosoNet ({vnet})")
        return generate
    if engine == "auto":
        print("EPR engine: native rule-based renderer (no virtuosoNet "
              "checkout found; set epr_engine=virtuosonet to require the "
              "tool)")
    else:
        print("EPR engine: native rule-based renderer (selected via "
              "epr_engine)")
    from piano_a2s_tpu_torch.data.epr_native import make_native_epr_generator
    # Stage inside the workspace when one is configured (the default
    # tempdir is removed at exit either way).
    staging = (os.path.join(exp.workspace, "epr_native_tmp")
               if exp.workspace else None)
    return make_native_epr_generator(staging)


def run_syn(exp, stages, kern_folder, xml_folder):
    from piano_a2s_tpu_torch.data import render as R
    versions = list(range(int(exp.extras.get("train_versions", 10))))
    if not versions:
        print("train_versions is 0 — nothing to do")
        return
    version_groups = [versions[i:i + 2] for i in range(0, len(versions), 2)]

    if "convert" in stages:
        print("Converting MuseSyn xml files to kern...")
        R.convert_xml_to_kern(xml_folder, kern_folder)
    if "preprocess" in stages:
        print("Preprocessing kern files...")
        R.preprocess_kern(kern_folder)
    if "split" in stages:
        print("Splitting scores into chunks...")
        _pool_map(partial(R.split_datasets, feature_folder=exp.feature_folder,
                          kern_folder=kern_folder, seed=exp.seed),
                  version_groups)
    if "midi" in stages:
        print("Converting xml to midi...")
        epr_generate = (make_epr_generate(exp) if exp.midi_syn == "epr"
                        else None)
        R.xml_to_midi(versions, exp.feature_folder, midi_syn=exp.midi_syn,
                      seed=exp.seed, epr_generate=epr_generate)
    if "clean" in stages:
        print("Cleaning files...")
        n = R.clean_files(versions, exp.feature_folder)
        print(f"deleted {n} invalid clips")
    if "render" in stages:
        print("Synthesizing audio...")
        soundfont_folder = exp.extras.get("soundfont_folder", "soundfonts")
        _pool_map(partial(R.render_all_midi,
                          feature_folder=exp.feature_folder,
                          soundfont_folder=soundfont_folder, seed=exp.seed),
                  version_groups)
    if "spectrograms" in stages:
        print("Preparing spectrograms...")
        n = sum(_pool_map(partial(R.prepare_spectrograms,
                                  feature_folder=exp.feature_folder,
                                  sample_rate=exp.sample_rate,
                                  max_duration=exp.max_duration),
                          version_groups))
        print(f"wrote {n} spectrograms under {exp.feature_folder}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dataset", choices=["syn", "asap"])
    parser.add_argument("hparams")
    parser.add_argument("stages", nargs="*", default=[],
                        help=f"syn stages subset of {ALL_STAGES}; "
                             "key=value args are config overrides")
    parser.add_argument("--kern-folder", default="data_processing/kern")
    parser.add_argument("--xml-folder", default="data_processing/xml")
    args = parser.parse_args(argv)

    overrides = [s for s in args.stages if "=" in s]
    args.stages = [s for s in args.stages if "=" not in s]

    exp = load_experiment(args.hparams, overrides)

    if args.dataset == "syn":
        stages = args.stages or ALL_STAGES
        unknown = [s for s in stages if s not in ALL_STAGES]
        if unknown:
            parser.error(f"unknown stage(s) {unknown}; valid: {ALL_STAGES}")
        run_syn(exp, stages, args.kern_folder, args.xml_folder)
    else:
        from piano_a2s_tpu_torch.data.asap import ProcessASAP
        proc = ProcessASAP(exp.asap_folder, exp.feature_folder,
                           sample_rate=exp.sample_rate,
                           max_duration=exp.max_duration)
        unmatched = proc.process_all()
        print(f"done; {len(unmatched)} unmatched performances")
    return 0


if __name__ == "__main__":
    sys.exit(main())
