"""Finetune on real recordings (ASAP) with the PyTorch port.

Usage:
    python -m piano_a2s_tpu_torch.cli.finetune configs/finetune.yaml \
        [key=value ...] [--device cuda|cpu] [--profile]

Warm-starts from the pretrain run's save folder
(<pretrained_output_folder>/save) when this run has no checkpoint of its
own: its checkpoints are imported with WER reset to 100, so that a new
best can register, and epoch 0, and the first restore runs a fresh
Adadelta at the config's lr (the reference's cp -r + CKPT.yaml rewrite;
reference: finetune.py:250-258). The valid split is the test split.
"""

import os
import sys

from piano_a2s_tpu_torch.cli.pretrain import parse_args


def main(argv=None):
    args = parse_args(argv, "Finetune on real recordings (ASAP)")

    from piano_a2s_tpu_torch.config import load_experiment
    from piano_a2s_tpu_torch.data.datasets import ASAPDataset, DataLoader
    from piano_a2s_tpu_torch.train.harness import Trainer

    exp = load_experiment(args.hparams, args.overrides)
    if args.profile:
        exp.extras["profile"] = True
    os.makedirs(exp.output_folder, exist_ok=True)
    exp.snapshot(exp.output_folder)

    trainer = Trainer(exp, device=args.device)
    pretrained_save = os.path.join(exp.pretrained_output_folder, "save")
    if not trainer.checkpointer.latest_path():
        if os.path.isdir(pretrained_save):
            trainer.checkpointer.import_from(
                pretrained_save, reset_meta={"WER": 100},
                reset_host_state={"epoch": 0, "global_step": 0})
        else:
            print(f"WARNING: no pretrained checkpoints at "
                  f"{pretrained_save!r} — finetuning from RANDOM weights")

    ds_kw = exp.dataset_kwargs()
    train_ds = ASAPDataset(exp.feature_folder, "train", **ds_kw)
    # valid == test in the reference finetune setup (finetune.py:261-263)
    test_ds = ASAPDataset(exp.feature_folder, "test", **ds_kw)

    trainer.fit(
        DataLoader(train_ds, exp.batch_size, shuffle=True, seed=exp.seed),
        DataLoader(test_ds, exp.batch_size))
    stats = trainer.evaluate(DataLoader(test_ds, exp.batch_size),
                             min_key="WER")
    print({k: round(v, 4) for k, v in stats.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
