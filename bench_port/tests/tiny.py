"""A tiny configuration of each entry, for CPU tests of the harness."""

import copy

from bench_port.harness import spec

TINY_MODEL = {
    "in_channels": 1, "freq_bins": 24, "conv_feature_size": 8,
    "hidden_size": 8, "max_bars": 2, "num_time_sig": 7, "num_keys": 14,
    "max_length": [12, 8], "note_emb_size": 4, "staff_emb_size": 4,
    "time_sig_emb_size": 5, "key_emb_size": 8, "vocab_size": 173,
    "sos": 145, "eos": 146, "pad": 147, "newline": 143}
TINY_VQT = {"sample_rate": 16000, "hop_length": 160, "fmin": 220.0,
            "bins_per_octave": 12, "n_octaves": 2, "gamma": 20.0,
            "filter_scale": 1.0, "window_size": 640}


def tiny_cell(name: str, batch: int = None, **traffic) -> spec.Cell:
    """The cell ``name`` (``<config>.<traffic>``, in BENCHMARK.json or only
    in the benchmark's files) at the tiny sizes, 0.5 s clips."""
    bench = spec.benchmark()
    if name not in {w["name"] for w in bench["workloads"]}:
        config, mix = name.split(".", 1)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": mix, "chips": 1})
    cell = copy.deepcopy(spec.cell(name, bench))
    cell.config["model"] = dict(TINY_MODEL)
    cell.config["vqt"] = dict(TINY_VQT)
    cell.config["frames"] = 51
    cell.traffic["clip_seconds"] = [0.5, 0.5]
    cell.traffic["pool"] = 2
    cell.traffic["sample_from"] = 1
    if batch:
        cell.traffic["batch"] = batch
    cell.traffic.update(traffic)
    return cell
