"""Export a checkpoint of a port save folder to the reference format.

Usage:
    python -m piano_a2s_tpu_torch.cli.export_checkpoint SAVE_FOLDER \
        [--config configs/pretrain.yaml] [--out DIR] [--latest] \
        [--modulelist]

Takes the best checkpoint by WER (or, with ``--latest``, the most recent)
of a save folder written by the port's training commands or by
``cli.import_checkpoint``, checks its weights strictly against the
config's model and writes a ``CKPT+export-<unixtime>`` directory holding
``model.ckpt``, a ``torch.save`` of the reference's
``ScoreTranscription.state_dict()`` (the port's parameter names are the
reference's; every ``num_batches_tracked`` is 0), and ``CKPT.yaml`` with
the WER, the loss, the export time and the source checkpoint.
``--modulelist`` prefixes every key with ``0.``, the layout of the
reference's SpeechBrain checkpointer, which wraps the model in a
``torch.nn.ModuleList``. The twin of the JAX package's
scripts/export_reference_checkpoint.py; host only.
"""

import argparse
import os
import sys
import time

OUT_HELP = ("output directory (default: <save_folder>/CKPT+export-"
            "<unixtime>; it holds no meta.json, so the next training run "
            "that saves into the same folder deletes it as the debris of an "
            "unfinished save: move it out, or pass --out)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Export a checkpoint of the port to the torch reference "
                    "format")
    ap.add_argument("save_folder",
                    help="a save folder of the port (Trainer save_folder)")
    ap.add_argument("--config", default="configs/pretrain.yaml",
                    help="experiment yaml fixing the model shape")
    ap.add_argument("--out", default=None, help=OUT_HELP)
    ap.add_argument("--latest", action="store_true",
                    help="export the most recent checkpoint instead of "
                         "the best-WER one")
    ap.add_argument("--modulelist", action="store_true",
                    help="prefix keys with '0.' (the reference "
                         "checkpointer's ModuleList layout) instead of "
                         "bare ScoreTranscription keys")
    args = ap.parse_args(argv)

    import torch

    from piano_a2s_tpu_torch.config import load_experiment
    from piano_a2s_tpu_torch.models import ScoreTranscription
    from piano_a2s_tpu_torch.train.checkpoint import Checkpointer

    exp = load_experiment(args.config)
    ckptr = Checkpointer(args.save_folder)
    path = ckptr.latest_path() if args.latest else ckptr.best_path()
    if path is None:
        sys.exit(f"no checkpoints under {args.save_folder}")
    trees, _, meta = ckptr.load(path, ("model",))
    print(f"exporting {path} (WER={meta.get('WER')})")

    model = ScoreTranscription(exp.model_config())
    model.load_state_dict(trees["model"], strict=True)
    sd = {k: (torch.tensor(0, dtype=torch.int64)
              if k.endswith("num_batches_tracked") else v.contiguous())
          for k, v in model.state_dict().items()}
    if args.modulelist:
        sd = {f"0.{k}": v for k, v in sd.items()}

    out = args.out or os.path.join(args.save_folder,
                                   f"CKPT+export-{int(time.time())}")
    os.makedirs(out, exist_ok=True)
    torch.save(sd, os.path.join(out, "model.ckpt"))
    with open(os.path.join(out, "CKPT.yaml"), "w") as f:
        f.write(f"WER: {float(meta.get('WER', 100.0))}\n")
        f.write(f"loss: {float(meta.get('loss', -1.0))}\n")
        f.write(f"unixtime: {time.time()}\n")
        f.write(f"exported_from: {path}\n")
    how = ("the reference checkpointer's ModuleList layout ('0.'-prefixed)"
           if args.modulelist else
           "ScoreTranscription().load_state_dict(torch.load(...))")
    print(f"wrote {out}/model.ckpt (+ CKPT.yaml); key layout: {how}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
