#!/usr/bin/env python3
"""Freeze the token lengths of the real bars of tests/fixtures/kern.

    python3 bench_port/data/freeze_bar_lengths.py > bench_port/data/bar_lengths.json

Each excerpt's staves are tokenized whole, as the data preparation does
for a chunk (spine extraction, cleaning, tie repair, voices merged and
sorted, the model's sub-token vocabulary), and each bar's token count is
kept. Run once on a CPU; the benchmark's runs read only the JSON.
"""

import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    sys.path.insert(0, ROOT)
    from piano_a2s_tpu_torch.data import render as R
    from piano_a2s_tpu_torch.symbolic.export import split_sequence_bars
    from piano_a2s_tpu_torch.symbolic.humdrum import (Kern, process_voices,
                                                      sort_chords,
                                                      sort_voices)
    from piano_a2s_tpu_torch.symbolic.vocab import LabelsMultiple

    labels = LabelsMultiple(extended=True)
    lengths = {"upper": [], "lower": []}
    per_file = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                              "kern", "*.krn"))):
        with open(path, encoding="iso-8859-1") as f:
            text = f.read()
        spine_lower, spine_upper = R.get_staff_spines(text)
        row = {}
        for staff, spine in (("lower", spine_lower), ("upper", spine_upper)):
            kern = Kern(data=R.extract_spine(text, spine))
            ok, _ = kern.clean()
            if not ok:
                raise ValueError(f"{path}: {staff} staff does not clean")
            kern = Kern(data=R.tiefix_kern(kern.dump()))
            seq = sort_voices(sort_chords(process_voices(kern))).tosequence()
            row[staff] = [len(labels.encode(b))
                          for b in split_sequence_bars(seq)]
            lengths[staff] += row[staff]
        per_file[os.path.basename(path)] = row
    commit = subprocess.run(["git", "-C", ROOT, "rev-parse", "HEAD"],
                            capture_output=True, text=True).stdout.strip()
    json.dump({"what": "tokens a bar (before <eos>) of each staff of the "
                       "four real-score excerpts of tests/fixtures/kern",
               "command": "python3 bench_port/data/freeze_bar_lengths.py",
               "commit": commit, "per_file": per_file, "lengths": lengths},
              sys.stdout, indent=1)
    print()


if __name__ == "__main__":
    main()
