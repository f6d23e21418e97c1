"""Pretrain on synthesized data with the PyTorch port.

Usage:
    python -m piano_a2s_tpu_torch.cli.pretrain configs/pretrain.yaml \
        [key=value ...] [--device cuda|cpu] [--profile]

The same configs and overrides as the JAX package's pretrain.py. The run
folder gets hyperparams.yaml, train_log.txt, save/ (checkpoints, best by
WER) and results/{valid,test}/ (one JSON per clip). ``--profile`` writes
profile/step_times.json and a torch.profiler trace of the first
``profile_trace_steps`` steps (default 3). Training from raw audio (the
VQT kernel inside every train and eval step on the card) is
``input_features=audio``.
"""

import argparse
import os
import sys


def parse_args(argv, description: str):
    """The arguments both training commands share."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("hparams", help="YAML config path")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    parser.add_argument("--data-parallel", action="store_true",
                        help="not ported yet")
    parser.add_argument("--multihost", action="store_true",
                        help="not ported yet")
    parser.add_argument("--profile", action="store_true",
                        help="time every train step (a device sync per "
                             "step) and trace the first steps to "
                             "<output_folder>/profile")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, cuda:N or cpu)")
    args = parser.parse_args(argv)
    if args.data_parallel or args.multihost:
        parser.error("--data-parallel and --multihost: data-parallel "
                     "training is not ported yet (ROADMAP Queue 1 item 3, "
                     "data parallel)")
    return args


def main(argv=None):
    args = parse_args(argv, "Pretrain on synthesized data")

    import numpy as np

    from piano_a2s_tpu_torch.config import load_experiment
    from piano_a2s_tpu_torch.data.datasets import (DataLoader,
                                                   SyntheticTestDataset,
                                                   SyntheticTrainDataset)
    from piano_a2s_tpu_torch.train.harness import Trainer

    exp = load_experiment(args.hparams, args.overrides)
    if args.profile:
        exp.extras["profile"] = True
    os.makedirs(exp.output_folder, exist_ok=True)
    # Snapshot the resolved config into the run folder (reference:
    # pretrain.py:263-267).
    exp.snapshot(exp.output_folder)

    n_train_versions = int(exp.extras.get("train_versions", 10))
    ds_kw = exp.dataset_kwargs()
    train_ds = SyntheticTrainDataset(
        exp.feature_folder, "train", versions=range(n_train_versions),
        rng=np.random.RandomState(exp.seed), **ds_kw)
    # 4 composer-EPR variants for 'epr', 1 for 'score'
    # (reference: pretrain.py:271-274)
    test_versions = range(4) if exp.midi_syn == "epr" else [0]
    valid_ds = SyntheticTestDataset(
        exp.feature_folder, "valid", versions=test_versions, **ds_kw)
    test_ds = SyntheticTestDataset(
        exp.feature_folder, "test", versions=test_versions, **ds_kw)

    trainer = Trainer(exp, device=args.device)
    trainer.fit(
        DataLoader(train_ds, exp.batch_size, shuffle=True, seed=exp.seed),
        DataLoader(valid_ds, exp.batch_size))
    stats = trainer.evaluate(DataLoader(test_ds, exp.batch_size),
                             min_key="WER")
    print({k: round(v, 4) for k, v in stats.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
