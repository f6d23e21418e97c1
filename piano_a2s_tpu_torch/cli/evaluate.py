"""Offline evaluation with the PyTorch port: MV2H + MUSTER + WER/F1
summaries.

Usage:
    python -m piano_a2s_tpu_torch.cli.evaluate [configs/finetune.yaml] \
        [key=value ...] [--split test] [--mv2h-engine auto|java|native] \
        [--muster [--muster-engine auto|external|native]] [--jobs N]

The same arguments, refusals, exit codes and printed lines as the JAX
package's evaluate.py, on the result records either package's Trainer
writes. It runs on the host only: no device, no torch.

Mirrors the reference's evaluate.py entry (reference: evaluate.py:174-186):
exports every test-result prediction and target to MusicXML/MIDI (native,
no external converters), runs the external MV2H Java tool on each pair,
and prints the summary tables. WER/F1 summaries work without Java.
"""

import argparse
import glob
import os
import shutil
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("hparams", nargs="?", default="configs/finetune.yaml")
    parser.add_argument("overrides", nargs="*")
    parser.add_argument("--split", default="test")
    parser.add_argument("--muster", action="store_true",
                        help="also compute the MUSTER 11-component score "
                             "error rate over the XML pairs exported by "
                             "the MV2H stage (the external MUSTER tool "
                             "when present — it writes ER.txt into the "
                             "cwd; reference: evaluate.py get_ER — else "
                             "the native scorer, train/muster.py)")
    parser.add_argument("--muster-script",
                        default="./MUSTER/evaluate_XML_voicePlus.sh",
                        metavar="SCRIPT",
                        help="path to MUSTER's evaluate_XML_voicePlus.sh")
    parser.add_argument("--muster-engine", default="auto",
                        choices=["auto", "external", "native"],
                        help="MUSTER scorer: the canonical external tool "
                             "or the native implementation "
                             "(train/muster.py). 'auto' uses the external "
                             "script when present, else native")
    parser.add_argument("--mv2h-engine", default="auto",
                        choices=["auto", "java", "native"],
                        help="MV2H scorer: the canonical Java tool or the "
                             "native implementation (train/mv2h.py). "
                             "'auto' uses java when it and the mv2h_bin "
                             "classpath are present, else native")
    parser.add_argument("--jobs", type=int, default=1,
                        help="concurrent MV2H workers (each clip's export "
                             "+ Java run is independent; the reference "
                             "evaluates strictly serially — N jobs cut a "
                             "large evaluation's wall time ~N-fold)")
    args = parser.parse_args(argv)

    from piano_a2s_tpu_torch.config import load_experiment
    from piano_a2s_tpu_torch.train.evaluate_offline import (
        get_muster_er, get_mv2h_from_test, muster_engine, mv2h_engine,
        summarize_asap_mv2h, summarize_syn_mv2h, summarize_wer_and_f1)

    exp = load_experiment(args.hparams, args.overrides)
    folders = [f for f in (exp.pretrained_output_folder, exp.output_folder)
               if f and os.path.isdir(os.path.join(f, "results", args.split))]
    if not folders:
        print("no results folders found; run pretrain/finetune first")
        return 1

    resolved = mv2h_engine(exp.mv2h_bin)
    engine = (args.mv2h_engine if args.mv2h_engine != "auto" else resolved)
    if engine == "java" and resolved != "java":
        # Forcing the Java scorer without java/classpath would make EVERY
        # clip an error and summarize over 0 clips — refuse up front.
        print("error: --mv2h-engine java requested but java + the "
              f"mv2h_bin classpath ({exp.mv2h_bin!r}) are not available "
              "on this host; install them or use --mv2h-engine native")
        return 1
    if engine == "native":
        if args.mv2h_engine == "native":
            print("MV2H engine: native scorer (selected via "
                  "--mv2h-engine; the Java tool remains canonical when "
                  "present)")
        else:
            print("MV2H engine: native scorer (java + MV2H classpath not "
                  "found; train/mv2h.py implements the published "
                  "algorithm — the Java tool remains canonical when "
                  "present)")
    for folder in folders:
        metrics, n = summarize_wer_and_f1(folder, args.split)
        print(f"{folder}: WER/F1 over {n} clips: "
              f"{ {k: round(v, 4) for k, v in metrics.items()} }")
        # 10 s/pair is the reference's contract (evaluate.py:40-60);
        # mv2h_timeout raises it for slow/loaded hosts.
        timeout = float(exp.extras.get("mv2h_timeout", 10.0))
        errors = get_mv2h_from_test(folder, args.split, exp.mv2h_bin,
                                    timeout=timeout, jobs=args.jobs,
                                    engine=engine)
        print(f"{folder}: MV2H export errors: {len(errors)}")
        if folder == exp.output_folder and "asap" in exp.feature_folder:
            m, four, n = summarize_asap_mv2h(folder, split=args.split)
        else:
            m, four, n = summarize_syn_mv2h(folder, split=args.split)
        print(f"{folder}: MV2H ({engine}) over {n} clips: "
              f"{ {k: round(v, 4) for k, v in m.items()} }, "
              f"4-way mean {four:.4f}")
        if args.muster:
            m_engine = (args.muster_engine if args.muster_engine != "auto"
                        else muster_engine(args.muster_script))
            if m_engine == "external" and not (
                    os.path.exists(args.muster_script)
                    or shutil.which(args.muster_script)):
                print(f"MUSTER tool not found "
                      f"(--muster-script={args.muster_script!r}): "
                      "skipping MUSTER (use --muster-engine native for "
                      "the in-repo scorer)")
            elif not glob.glob(os.path.join(folder, "results", "mv2h",
                                            "*.json")):
                # Covers both "stage never ran" and "stage ran but every
                # export failed" — an 'ER over 0 pairs' line would read
                # as a perfect score.
                print(f"{folder}: no MV2H exports yet (MUSTER consumes the "
                      "XML pairs the MV2H stage writes): skipping MUSTER")
            else:
                ers, n_pairs = get_muster_er(folder, args.muster_script,
                                             engine=m_engine,
                                             split=args.split)
                if m_engine == "native":
                    # Only the native engine's component order is ours to
                    # label; the external tool's 11 numbers print raw,
                    # like the reference (evaluate.py:163).
                    from piano_a2s_tpu_torch.train.muster import \
                        MUSTER_COMPONENTS
                    body = str({c: round(float(e), 4) for c, e in
                                zip(MUSTER_COMPONENTS, ers)})
                else:
                    body = str([round(float(e), 4) for e in ers])
                print(f"{folder}: MUSTER ({m_engine}) ER over {n_pairs} "
                      f"pairs: {body}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
