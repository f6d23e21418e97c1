"""Finetune on real recordings (ASAP) with the PyTorch port.

Usage:
    python -m piano_a2s_tpu_torch.cli.finetune configs/finetune.yaml \
        [key=value ...] [--device cuda|cpu] [--profile] [--data-parallel]

(``--data-parallel`` under torchrun, as for cli.pretrain.)

Warm-starts from the pretrain run's save folder
(<pretrained_output_folder>/save) when this run has no checkpoint of its
own: its checkpoints are imported with WER reset to 100, so that a new
best can register, and epoch 0, and the first restore runs a fresh
Adadelta at the config's lr (the reference's cp -r + CKPT.yaml rewrite;
reference: finetune.py:250-258). The valid split is the test split.
Under --data-parallel rank 0 alone decides and makes the import, and a
barrier follows before any rank looks for a checkpoint.
"""

import os
import sys

from piano_a2s_tpu_torch.cli.pretrain import parse_args, setup


def main(argv=None):
    args = parse_args(argv, "Finetune on real recordings (ASAP)")

    from piano_a2s_tpu_torch import parallel
    from piano_a2s_tpu_torch.data.datasets import ASAPDataset, DataLoader
    from piano_a2s_tpu_torch.train.harness import Trainer

    exp, shard = setup(args)
    trainer = Trainer(exp, device=args.device, use_mesh=args.data_parallel)
    pretrained_save = os.path.join(exp.pretrained_output_folder, "save")
    # Rank 0 alone looks and copies: another rank could see a half-copied
    # checkpoint directory. The barrier makes the import visible to all.
    if trainer.is_main_process and not trainer.checkpointer.latest_path():
        if os.path.isdir(pretrained_save):
            trainer.checkpointer.import_from(
                pretrained_save, reset_meta={"WER": 100},
                reset_host_state={"epoch": 0, "global_step": 0})
        else:
            print(f"WARNING: no pretrained checkpoints at "
                  f"{pretrained_save!r} — finetuning from RANDOM weights")
    trainer.barrier("finetune:after-warmstart-import")

    ds_kw = exp.dataset_kwargs()
    train_ds = ASAPDataset(exp.feature_folder, "train", **ds_kw)
    # valid == test in the reference finetune setup (finetune.py:261-263)
    test_ds = ASAPDataset(exp.feature_folder, "test", **ds_kw)

    trainer.fit(
        DataLoader(train_ds, exp.batch_size, shuffle=True, seed=exp.seed,
                   shard=shard, accum_steps=trainer.accum_steps),
        DataLoader(test_ds, exp.batch_size))
    stats = trainer.evaluate(DataLoader(test_ds, exp.batch_size),
                             min_key="WER")
    if trainer.is_main_process:
        print({k: round(v, 4) for k, v in stats.items()})
    if args.data_parallel:
        parallel.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
