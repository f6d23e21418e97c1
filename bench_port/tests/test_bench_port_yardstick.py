"""The benchmark's yardstick on the CPU: the counts of operations and
bytes, the traffic generator, and finding every piece by its name."""

import json
import os

import numpy as np
import pytest

from bench_port.harness import counts, spec, traffic as T
from bench_port.harness.reference import param_spec

BENCH = spec.benchmark()
SERVE = spec.cell("serve_f32.offline_caps")
TRAIN = spec.cell("pretrain_f32.real_lengths")


def test_k1_counts_at_the_served_shape():
    vqt = SERVE.config["vqt"]
    assert counts.nonzero_taps(vqt) == 273036      # of 1120 x 480 = 537600
    ops, nbytes = counts.vqt_cost(vqt, 16, 192000)
    assert ops == 4.0 * 16 * 1201 * 273036
    assert nbytes == 4 * (16 * 192000 + 2 * 1120 * 480 + 16 * 1201 * 480)
    # Bound by operations at the TF32 peak, not by bytes.
    assert ops / 494.7e12 > nbytes / 3.35e12


def test_decode_counts_follow_the_stop_groups():
    m, frames = SERVE.config["model"], SERVE.config["frames"]
    caps = np.array([[[398], [189]]] * 5)               # (bars, 2, groups)
    ops, nbytes, steps = counts.decode_cost(m, frames, caps, 16)
    assert steps == 5 * 398
    both = counts.note_step_bytes(m, 16, frames)
    enc = 4 * 16 * frames * 512
    assert nbytes == pytest.approx(5 * (398 * (enc + both) + 189 * both))
    assert ops == pytest.approx(
        5 * (398 + 189) * counts.note_step_flops(m, 16, frames))
    # A group that stops early costs only the steps it needs.
    early = caps.copy()
    early[:, 0, 0] = 10
    assert counts.decode_cost(m, frames, early, 16)[1] < nbytes
    # A step reads about 60-120 MB at batch 16 (the per-step bound).
    assert 60e6 < (enc + 2 * both) < 120e6


def test_step_counts_at_the_training_widths():
    m, vqt = TRAIN.config["model"], TRAIN.config["vqt"]
    ops = counts.train_step_flops(m, vqt, 4, 192000, 1201, (64, 64))
    fwd = (ops - counts.vqt_cost(vqt, 4, 192000)[0]) / 3
    assert fwd > counts.convstack_flops(m, 4, 1201)
    wider = counts.train_step_flops(m, vqt, 4, 192000, 1201, (128, 64))
    assert wider > ops
    # A served clip at the caps is tens of GFLOP, most of it the ConvStack.
    per_clip = counts.serve_batch_flops(
        m, vqt, 1, 192000, 1201, np.array([[[398], [189]]] * 5), 1)
    assert 40e9 < per_clip < 80e9
    assert counts.convstack_flops(m, 1, 1201) / per_clip > 0.5


@pytest.mark.parametrize("name", ["offline_caps", "real_lengths"])
def test_traffic_is_a_function_of_the_seed(name):
    mix = spec._json("traffic", f"{name}.json")
    a = T.clips(mix, 2 ** 31 + 99, 0, 3, 16000)
    b = T.clips(mix, 2 ** 31 + 99, 0, 3, 16000)
    c = T.clips(mix, 7, 0, 3, 16000)
    for x, y, z in zip(a, b, c):
        assert x.dtype == np.dtype(mix["audio"]["dtype"])
        assert np.array_equal(x, y) and not np.array_equal(x, z)
        assert x.shape == z.shape == (192000,)


def test_targets_use_real_bar_lengths_and_bucket():
    mix, m = TRAIN.traffic, TRAIN.config["model"]
    lengths = T.bar_lengths(mix)
    assert (len(lengths["upper"]), max(lengths["upper"])) == (43, 47)
    t1 = T.targets(mix, m, 3, 0, lengths)
    t2 = T.targets(mix, m, 3, 0, lengths)
    for k in t1:
        assert np.array_equal(t1[k], t2[k])
    for staff in ("upper", "lower"):
        toks, n = t1[staff], t1[f"{staff}_lengths"]
        assert toks.shape[-1] == 64             # the real bars bucket to 64
        assert set(np.unique(n)) <= set(lengths[staff])
        eos = (toks == m["eos"]).argmax(-1)
        assert np.array_equal(eos, n)
        assert not np.isin(toks[..., :1], [m["sos"], m["pad"]]).any()
    assert t1["time_sig"].max() < m["num_time_sig"]
    assert t1["key"].max() < m["num_keys"]


def test_every_piece_is_found_by_its_name():
    root = spec.ROOT
    assert BENCH["paths"] == ["bench_port"]
    for c in BENCH["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert spec.entry(cell.traffic["entry"]).run
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_the_weights_cover_the_state_dict():
    # 98 tensors, less the five BatchNorm step counters.
    names = [n for n, *_ in param_spec(SERVE.config["model"])]
    assert len(names) == len(set(names)) == 93
