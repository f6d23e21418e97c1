"""Import a PyTorch checkpoint into a save folder of the port.

Usage:
    python -m piano_a2s_tpu_torch.cli.import_checkpoint SRC \
        [--config configs/pretrain.yaml] [--out SAVE_FOLDER] [--wer WER]

SRC is the reference's SpeechBrain save folder (<output_folder>/save with
CKPT+* subdirectories; the one with the best WER in its CKPT.yaml is
taken), one CKPT+* directory, or a bare model .ckpt/.pt file (a state
dict, ``{"state_dict": ...}`` or a ``0.``-prefixed ModuleList, as
``scripts/export_reference_checkpoint.py`` writes from the JAX package).
The weights are checked against the config's model and written as one
checkpoint of a port save folder (default: the config's ``save_folder``):
model.pt, a fresh Adadelta at the config's lr/rho/eps, host state at epoch
0 and step 0, and meta.json with the WER (``--wer``, else CKPT.yaml's,
else 100), the loss and the source. ``cli.finetune`` warm-starts from that
folder (set its ``pretrained_output_folder`` to the folder's parent) and
``load_transcriber`` serves it. The twin of the JAX package's
scripts/convert_reference_checkpoint.py.
"""

import argparse
import os
import sys


def _read_ckpt_yaml(path):
    """SpeechBrain CKPT.yaml: flat `key: value` lines (WER, unixtime...)."""
    meta = {}
    if not os.path.exists(path):
        return meta
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            try:
                meta[k.strip()] = float(v.strip())
            except ValueError:
                meta[k.strip()] = v.strip()
    return meta


def _resolve(src):
    """-> (model_ckpt_path, ckpt_yaml_meta). Picks the best-WER CKPT dir
    when given a whole save folder."""
    if os.path.isfile(src):
        return src, _read_ckpt_yaml(
            os.path.join(os.path.dirname(src), "CKPT.yaml"))
    if os.path.isfile(os.path.join(src, "model.ckpt")):
        return (os.path.join(src, "model.ckpt"),
                _read_ckpt_yaml(os.path.join(src, "CKPT.yaml")))
    ckpts = [os.path.join(src, d) for d in os.listdir(src)
             if d.startswith("CKPT") and
             os.path.isfile(os.path.join(src, d, "model.ckpt"))]
    if not ckpts:
        raise SystemExit(f"no model.ckpt found under {src}")
    wers = {c: _read_ckpt_yaml(os.path.join(c, "CKPT.yaml")).get("WER")
            for c in ckpts}
    if all(not isinstance(w, float) for w in wers.values()):
        # Make the arbitrary pick visible instead of pretending that a
        # best-WER selection happened (CKPT.yaml absent or not flat).
        best = min(ckpts)
        print(f"WARNING: no parseable WER metadata in any CKPT.yaml under "
              f"{src}; using {os.path.basename(best)} (alphabetically "
              f"first of {len(ckpts)})")
    else:
        best = min(ckpts, key=lambda c: wers[c]
                   if isinstance(wers[c], float) else float("inf"))
    return (os.path.join(best, "model.ckpt"),
            _read_ckpt_yaml(os.path.join(best, "CKPT.yaml")))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="reference save folder, CKPT dir, or .ckpt")
    ap.add_argument("--config", default="configs/pretrain.yaml",
                    help="experiment YAML giving model dims + save_folder")
    ap.add_argument("--out", default=None,
                    help="destination save folder (default: the config's)")
    ap.add_argument("--wer", type=float, default=None,
                    help="the WER recorded in the checkpoint's meta "
                         "(default: CKPT.yaml's, else 100)")
    args = ap.parse_args(argv)

    from piano_a2s_tpu_torch.config import load_experiment
    from piano_a2s_tpu_torch.models import ScoreTranscription
    from piano_a2s_tpu_torch.models.convert import load_torch_checkpoint
    from piano_a2s_tpu_torch.train.checkpoint import Checkpointer
    from piano_a2s_tpu_torch.train.step import make_optimizer

    exp = load_experiment(args.config)
    model_path, sb_meta = _resolve(args.src)
    print(f"importing {model_path}")
    model = ScoreTranscription(exp.model_config())
    model.load_state_dict(load_torch_checkpoint(model_path), strict=True)
    optimizer = make_optimizer(model.parameters(), lr=exp.lr,
                               rho=float(exp.extras.get("rho", 0.95)),
                               eps=float(exp.extras.get("eps", 1e-8)))

    wer = args.wer if args.wer is not None else sb_meta.get("WER", 100.0)
    out = args.out or exp.save_folder
    path = Checkpointer(out).save(
        {"model": model.state_dict(), "optimizer": optimizer.state_dict()},
        meta={"WER": float(wer), "loss": float(sb_meta.get("loss", -1.0)),
              "imported_from": model_path},
        host_state={"epoch": 0, "global_step": 0})
    print(f"wrote {path} (WER={wer}); cli.finetune warm-starts from "
          f"{out} and load_transcriber serves it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
