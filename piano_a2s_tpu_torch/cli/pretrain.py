"""Pretrain on synthesized data with the PyTorch port.

Usage:
    python -m piano_a2s_tpu_torch.cli.pretrain configs/pretrain.yaml \
        [key=value ...] [--device cuda|cpu] [--profile]
    python -m torch.distributed.run --nproc_per_node N \
        -m piano_a2s_tpu_torch.cli.pretrain configs/pretrain.yaml \
        [key=value ...] --data-parallel [--device cuda|cpu]

The same configs and overrides as the JAX package's pretrain.py. The run
folder gets hyperparams.yaml, train_log.txt, save/ (checkpoints, best by
WER) and results/{valid,test}/ (one JSON per clip). ``--profile`` writes
profile/step_times.json and a torch.profiler trace of the first
``profile_trace_steps`` steps (default 3). Training from raw audio (the
VQT kernel inside every train and eval step on the card) is
``input_features=audio``.

``--data-parallel`` (under torchrun; ``--multihost`` is the same, as
torchrun's environment already spans hosts) trains one process per device
(NCCL on the card, gloo on the CPU): ``batch_size`` is per device, so the
global batch is batch_size x world size, as the JAX package's
--data-parallel multiplies it by the device count. Each rank loads its own
rows of the train batches; the eval loaders stay replicated. Rank 0 alone
writes checkpoints and every rank restores rank 0's choice, so across
hosts the save folder must be on a filesystem they share (checked: a rank
that cannot see the checkpoint fails them all).
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
                        help="one process per device over torch.distributed;"
                             " run under torchrun (python -m "
                             "torch.distributed.run --nproc_per_node N ...)")
    parser.add_argument("--multihost", action="store_true",
                        help="the same as --data-parallel (torchrun's "
                             "environment spans the hosts; the save folder "
                             "must be on a filesystem they share)")
    parser.add_argument("--profile", action="store_true",
                        help="time every train step (a device sync per "
                             "step) and trace the first steps to "
                             "<output_folder>/profile")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, cuda:N or cpu)")
    args = parser.parse_args(argv)
    args.data_parallel = args.data_parallel or args.multihost
    if args.data_parallel:
        missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                               "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            parser.error(f"--data-parallel runs under torchrun (python -m "
                         f"torch.distributed.run --nproc_per_node N -m "
                         f"piano_a2s_tpu_torch.cli.pretrain ...): "
                         f"{', '.join(missing)} not set")
    return args


def setup(args):
    """The experiment of ``args`` with --profile applied, its run folder
    made and its config snapshot written (by rank 0); under
    --data-parallel the process group joined first and the batch size made
    global. Returns (exp, train loader shard or None)."""
    from piano_a2s_tpu_torch import parallel
    from piano_a2s_tpu_torch.config import load_experiment

    if args.data_parallel:
        parallel.distributed_init(device=args.device)
    exp = load_experiment(args.hparams, args.overrides)
    if args.profile:
        exp.extras["profile"] = True
    os.makedirs(exp.output_folder, exist_ok=True)
    if parallel.is_main():
        # Snapshot the resolved config into the run folder (reference:
        # pretrain.py:263-267).
        exp.snapshot(exp.output_folder)
    shard = None
    if args.data_parallel:
        exp.batch_size *= parallel.world()
        if parallel.world() > 1:
            shard = (parallel.rank(), parallel.world())
    return exp, shard


def main(argv=None):
    args = parse_args(argv, "Pretrain on synthesized data")

    import numpy as np

    from piano_a2s_tpu_torch import parallel
    from piano_a2s_tpu_torch.data.datasets import (DataLoader,
                                                   SyntheticTestDataset,
                                                   SyntheticTrainDataset)
    from piano_a2s_tpu_torch.train.harness import Trainer

    exp, shard = setup(args)

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

    trainer = Trainer(exp, device=args.device, use_mesh=args.data_parallel)
    trainer.fit(
        DataLoader(train_ds, exp.batch_size, shuffle=True, seed=exp.seed,
                   shard=shard, accum_steps=trainer.accum_steps),
        DataLoader(valid_ds, exp.batch_size))
    stats = trainer.evaluate(DataLoader(test_ds, exp.batch_size),
                             min_key="WER")
    if trainer.is_main_process:
        print({k: round(v, 4) for k, v in stats.items()})
    if args.data_parallel:
        parallel.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
