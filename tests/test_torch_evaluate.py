"""The port's offline evaluation against the JAX package's, on the CPU.

piano_a2s_tpu_torch keeps its own copies of the JAX package's host
evaluation modules (symbolic/midi_io.py, train/mv2h.py, train/muster.py,
train/evaluate_offline.py, cli/evaluate.py). Copies of host code are held
to exact equality: the same inputs give the same files, byte for byte, and
the same numbers, == for floats.

The inputs are drawn from a seed with numpy: result folders of 8-12 clips
in the synthetic id format (version~chunk~soundfont) whose targets are
5-bar chordal kern (durations, pitches, rests, chords, ties) and whose
predictions are the targets with substitutions, drops, insertions and
changed key or time signatures, one clip of garbage tokens and one whose
target file is missing. Two copies of a folder go through the two
packages. Also here: the hand-derived MV2H goldens, the real-music kern
fixtures, the external tools' contracts (fake java and MUSTER), the
evaluate command against the root evaluate.py, the port Trainer's own
result records, and the model self-test twin.
"""

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import piano_a2s_tpu.models.__main__ as jself_test
import piano_a2s_tpu.symbolic.midi_io as jmidi_io
import piano_a2s_tpu.train.evaluate_offline as jeval
import piano_a2s_tpu.train.muster as jmuster
import piano_a2s_tpu.train.mv2h as jmv2h
import piano_a2s_tpu_torch.config as tconfig
import piano_a2s_tpu_torch.data.datasets as tdata
import piano_a2s_tpu_torch.models.__main__ as tself_test
import piano_a2s_tpu_torch.symbolic.midi_io as tmidi_io
import piano_a2s_tpu_torch.train.evaluate_offline as teval
import piano_a2s_tpu_torch.train.harness as tharness
import piano_a2s_tpu_torch.train.muster as tmuster
import piano_a2s_tpu_torch.train.mv2h as tmv2h
from conftest import REPO_ROOT
from piano_a2s_tpu.data.render import load_time_signatures, \
    split_single_score
from piano_a2s_tpu.symbolic.export import export_target as j_export
from piano_a2s_tpu.symbolic.vocab import LabelsMultiple as JLabels
from piano_a2s_tpu_torch.data.synth import draw_song_chordal
from piano_a2s_tpu_torch.symbolic.export import export_target as t_export
from piano_a2s_tpu_torch.symbolic.vocab import LabelsMultiple
from test_external_tool_contracts import (FAKE_MUSTER, _install_fake_muster,
                                          _make_muster_fixture,
                                          _make_result_fixture,
                                          _write_test_midi)
from test_external_tool_contracts import fake_bin  # noqa: F401 (fixture)
from test_mv2h_goldens import CASES, EXPECTED, GOLDEN_DIR
from test_real_scores import FIXTURES

torch.set_num_threads(2)

LM = LabelsMultiple(extended=True)
NEWLINE = LM.labels_map["\n"]
PITCHES = [i for i, t in enumerate(LM.labels)
           if t.rstrip("#-").isalpha() and t != "r"]
TIME_SIGS = load_time_signatures()
SOUNDFONTS = ("Upright", "Salamander", "YDP")
INSERTS = ("8e", "4G", "16cc#", "8r", "4c 4e")
# Every filter of summarize_syn_mv2h, and the split restriction.
SYN_FILTERS = ([{}, {"split": "test"}, {"split": "valid"}]
               + [{"composer": c} for c in ("score", "Bach", "Mozart",
                                            "Chopin")]
               + [{"soundfont": s} for s in SOUNDFONTS]
               + [{"test_split": t} for t in ("musesyn", "humsyn")]
               + [{"composer": "Bach", "soundfont": "YDP",
                   "test_split": "humsyn", "split": "test"}])


# ---------------------------------------------------------------------------
# Result folders drawn from a seed
# ---------------------------------------------------------------------------

def _events(seq):
    """A staff's token ids cut into its events at the newline token."""
    events, cur = [], []
    for t in seq:
        if t == NEWLINE:
            events.append(cur)
            cur = []
        else:
            cur.append(int(t))
    return events + [cur]


def _join(events):
    seq = []
    for i, e in enumerate(events):
        seq += ([NEWLINE] if i else []) + e
    return seq


def _perturb(rng, target):
    """The target with, on each staff of each bar, a pitch substituted, an
    event dropped or an event inserted (or nothing), and some bars' key or
    time signature changed."""
    pred = []
    for key, ts, lower, upper in target:
        staves = []
        for seq in (lower, upper):
            events = _events(seq)
            op, i = rng.randint(4), rng.randint(len(events))
            if op == 0:
                at = [j for j, t in enumerate(events[i]) if t in PITCHES]
                if at:
                    events[i][at[rng.randint(len(at))]] = \
                        PITCHES[rng.randint(len(PITCHES))]
            elif op == 1 and len(events) > 1:
                del events[i]
            elif op == 2:
                events.insert(i, LM.encode(INSERTS[rng.randint(
                    len(INSERTS))]))
            staves.append(_join(events))
        if rng.rand() < 0.3:
            key = int(np.clip(key + (1 if rng.rand() < 0.5 else -1), -6, 7))
        if rng.rand() < 0.3:
            ts = TIME_SIGS[rng.randint(len(TIME_SIGS))]
        pred.append([key, ts, staves[0], staves[1]])
    return pred


def _garbage(rng):
    return [[int(rng.randint(-6, 8)), TIME_SIGS[rng.randint(7)],
             rng.randint(0, len(LM.labels), rng.randint(5, 40)).tolist(),
             rng.randint(0, len(LM.labels), rng.randint(5, 40)).tolist()]
            for _ in range(5)]


def _write_results(root, seed, split="test"):
    """A result folder of 8-12 clips in the Trainer's record format at
    root/out/results/{split} (clip 0 predicts garbage tokens, clip 1's
    target file is missing), the targets under root/targets. Returns the
    output folder."""
    rng = np.random.RandomState(seed)
    out = os.path.join(root, "out")
    split_dir = os.path.join(out, "results", split)
    targets = os.path.join(root, "targets")
    os.makedirs(split_dir)
    os.makedirs(targets)
    for i in range(rng.randint(8, 13)):
        target, _ = draw_song_chordal(rng)
        pred = _garbage(rng) if i == 0 else _perturb(rng, target)
        chunk = f"{'Song' if rng.rand() < 0.5 else 'song'}{i}.{rng.randint(3)}"
        clip_id = f"{rng.randint(4)}~{chunk}~{SOUNDFONTS[rng.randint(3)]}"
        target_path = os.path.join(targets, f"{i}.pkl")
        if i != 1:
            with open(target_path, "wb") as f:
                pickle.dump(target, f)
        record = {"style": "classical" if chunk[0].islower() else "pop",
                  "soundfont": clip_id.split("~")[2], "composer": "synth",
                  "target_path": target_path, "pred": pred,
                  "wer_upper": float(rng.rand()),
                  "wer_lower": float(rng.rand()),
                  "key_f1": float(rng.rand()), "time_f1": float(rng.rand())}
        with open(os.path.join(split_dir, f"{clip_id}.json"), "w") as f:
            json.dump(record, f, indent=2)
    return out


def _copies(out, root):
    """Two identical copies of the output folder ``out``."""
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    shutil.copytree(out, a)
    shutil.copytree(out, b)
    return a, b


def _files(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, names in os.walk(folder) for f in names)


def _assert_same_tree(a, b):
    """The same files under both folders, byte for byte."""
    assert _files(a) == _files(b)
    for rel in _files(a):
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def _assert_same_summaries(a, b, split="test"):
    for kw in SYN_FILTERS:
        assert (jeval.summarize_syn_mv2h(a, **kw)
                == teval.summarize_syn_mv2h(b, **kw)), kw
    assert (jeval.summarize_wer_and_f1(a, split)
            == teval.summarize_wer_and_f1(b, split))
    for kw in ({}, {"split": split}):
        ers_j, n_j = jeval.get_muster_er(a, engine="native", **kw)
        ers_t, n_t = teval.get_muster_er(b, engine="native", **kw)
        assert n_j == n_t and np.array_equal(ers_j, ers_t), kw


def _scored(folder):
    return sorted(os.listdir(os.path.join(folder, "results", "mv2h")))


@pytest.mark.parametrize("seed,jobs", [(0, 1), (1, 1), (0, 3), (2, 3)])
def test_native_evaluation_equals_jax(tmp_path, seed, jobs):
    """Per-clip exports, MV2H JSONs and errors.txt byte-equal; every
    summary and the native MUSTER rates equal."""
    a, b = _copies(_write_results(str(tmp_path), seed), str(tmp_path))
    errors_j = jeval.get_mv2h_from_test(a, "test", "", jobs=jobs,
                                        engine="native")
    errors_t = teval.get_mv2h_from_test(b, "test", "", jobs=jobs,
                                        engine="native")
    assert errors_t == errors_j
    n_clips = len(os.listdir(os.path.join(a, "results", "test")))
    scored = _scored(b)
    # The missing target is an error; most clips score.
    assert any("~song1." in e or "~Song1." in e for e in errors_t)
    assert len(scored) + len(errors_t) == n_clips and len(scored) >= 5
    _assert_same_tree(os.path.join(a, "results"),
                      os.path.join(b, "results"))
    _assert_same_summaries(a, b)
    # The synthetic-id filter counts every scored clip.
    assert teval.summarize_syn_mv2h(b)[2] == len(scored)
    # A second pass resumes: nothing re-scored, the same errors.
    assert teval.get_mv2h_from_test(b, "test", "", jobs=jobs,
                                    engine="native") == errors_t
    _assert_same_tree(os.path.join(a, "results"),
                      os.path.join(b, "results"))


@pytest.mark.parametrize("split", [None, "test"])
def test_asap_summary_equals_jax(tmp_path, split):
    """summarize_asap_mv2h (and the synthetic summary) on a folder mixing
    ASAP and synthetic ids, with and without the split's id filter."""
    rng = np.random.RandomState(5)
    out = str(tmp_path / "out")
    mv2h_dir = os.path.join(out, "results", "mv2h")
    split_dir = os.path.join(out, "results", "test")
    os.makedirs(mv2h_dir)
    os.makedirs(split_dir)
    ids = ([f"asap~Bach~Prelude~bwv_{i}~{j}" for i in (846, 875)
            for j in range(3)]
           + [f"{v}~Song{v}.0~{SOUNDFONTS[v % 3]}" for v in range(4)])
    for i, clip_id in enumerate(ids):
        scores = {k: float(rng.rand()) for k in jeval.MV2H_KEYS}
        with open(os.path.join(mv2h_dir, f"{clip_id}_mv2h.json"), "w") as f:
            json.dump(scores, f)
        if i % 2 == 0:
            with open(os.path.join(split_dir, f"{clip_id}.json"), "w") as f:
                json.dump({}, f)
    got = teval.summarize_asap_mv2h(out, split=split)
    assert got == jeval.summarize_asap_mv2h(out, split=split)
    assert got[2] == (6 if split is None else 5)
    assert (teval.summarize_syn_mv2h(out, split=split)
            == jeval.summarize_syn_mv2h(out, split=split))


# ---------------------------------------------------------------------------
# The scorers on fixed inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_mv2h_goldens(case):
    """The hand-derived worked examples (tests/goldens/mv2h_worked):
    the port's scores equal JAX's, and both reproduce expected.json as
    tests/test_mv2h_goldens.py holds JAX to it."""
    got, ref = [], []
    for side in ("gt", "tr"):
        with open(os.path.join(GOLDEN_DIR, f"{case}_{side}.txt")) as f:
            text = f.read()
        got.append(tmv2h.parse_score(text))
        ref.append(jmv2h.parse_score(text))
        assert got[-1].to_text() == ref[-1].to_text()
    result = tmv2h.evaluate_mv2h(*got, align=True)
    assert result == jmv2h.evaluate_mv2h(*ref, align=True)
    for key, want in EXPECTED[case].items():
        np.testing.assert_allclose(result[key], want, atol=1e-12,
                                   err_msg=f"{case} {key}")


@pytest.fixture(scope="module")
def kern_targets(tmp_path_factory):
    """Each real-music fixture tokenized by the JAX package: its first
    5-bar test chunk."""
    root = str(tmp_path_factory.mktemp("kern"))
    labels = JLabels(extended=True)
    targets = {}
    for path in FIXTURES:
        name = os.path.basename(path).split(".")[0]
        split_single_score(path, root, labels, load_time_signatures(),
                           split="test", version=0,
                           rng=np.random.RandomState(0))
        with open(os.path.join(root, "test", "0", "target",
                               f"{name}.0.pkl"), "rb") as f:
            targets[name] = pickle.load(f)
    return targets


@pytest.mark.parametrize("fixture", range(len(FIXTURES)))
def test_kern_fixture_scores_equal_jax(kern_targets, tmp_path, fixture):
    """A real-music chunk against a perturbed copy: exports byte-equal,
    then read_midi, midi_to_score, run_native_mv2h_pair, parse_musicxml,
    stem_direction and native_muster_pair equal, each package on its own
    files."""
    name = sorted(kern_targets)[fixture]
    target = kern_targets[name]
    pred = _perturb(np.random.RandomState(fixture), target)
    paths = {}
    for pkg, export in (("j", j_export), ("t", t_export)):
        d = tmp_path / pkg
        d.mkdir()
        for side, score in (("target", target), ("pred", pred)):
            paths[pkg, side] = (str(d / f"{side}.xml"), str(d / f"{side}.mid"))
            export(score, *paths[pkg, side])
    for side in ("target", "pred"):
        for j, t in zip(paths["j", side], paths["t", side]):
            with open(j, "rb") as fj, open(t, "rb") as ft:
                assert fj.read() == ft.read(), (name, side)
        j_xml, j_mid = paths["j", side]
        t_xml, t_mid = paths["t", side]
        assert (dataclasses.asdict(tmidi_io.read_midi(t_mid))
                == dataclasses.asdict(jmidi_io.read_midi(j_mid)))
        assert (tmv2h.midi_to_score(t_mid).to_text()
                == jmv2h.midi_to_score(j_mid).to_text())
        t_score = tmuster.parse_musicxml(t_xml)
        j_score = jmuster.parse_musicxml(j_xml)
        assert dataclasses.asdict(t_score) == dataclasses.asdict(j_score)
        assert ([tmuster.stem_direction(n) for n in t_score.notes]
                == [jmuster.stem_direction(n) for n in j_score.notes])
    got = tmv2h.run_native_mv2h_pair(paths["t", "target"][1],
                                     paths["t", "pred"][1])
    assert got == jmv2h.run_native_mv2h_pair(paths["j", "target"][1],
                                             paths["j", "pred"][1])
    assert got["MV2H"] < 1.0
    ers = tmuster.native_muster_pair(paths["t", "target"][0],
                                     paths["t", "pred"][0])
    assert np.array_equal(ers, jmuster.native_muster_pair(
        paths["j", "target"][0], paths["j", "pred"][0]))
    assert len(ers) == len(tmuster.MUSTER_COMPONENTS) == 11


# ---------------------------------------------------------------------------
# The external tools' contracts (fake java and MUSTER)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["parse", "timeout", "malformed"])
def test_run_mv2h_pair_contract(fake_bin, tmp_path, monkeypatch,  # noqa: F811
                                case):
    """The port's run_mv2h_pair runs its own copy of the shell contract:
    the same java calls and parse as JAX's, None on a timeout and on
    malformed output."""
    ref_mid, hyp_mid = tmp_path / "ref.mid", tmp_path / "hyp.mid"
    _write_test_midi(ref_mid)
    _write_test_midi(hyp_mid, pitches=(62, 65))
    timeout = 60
    if case == "timeout":
        monkeypatch.setenv("FAKE_JAVA_SLEEP", "5")
        timeout = 1.0
    elif case == "malformed":
        monkeypatch.setenv("FAKE_JAVA_GARBAGE", "1")
    calls = {}
    results = {}
    for pkg, mod in (("j", jeval), ("t", teval)):
        log = tmp_path / f"{pkg}.log"
        monkeypatch.setenv("FAKE_JAVA_LOG", str(log))
        results[pkg] = mod.run_mv2h_pair(str(ref_mid), str(hyp_mid),
                                         "/opt/MV2H/bin", timeout=timeout)
        calls[pkg] = log.read_text().splitlines() if log.exists() else []
    assert results["t"] == results["j"]
    if case == "parse":
        assert set(results["t"]) == set(tmv2h.MV2H_KEYS)
        assert results["t"]["Multi-pitch"] == 0.75
        assert calls["t"] == calls["j"] and len(calls["t"]) == 3
        assert not os.path.exists(f"{ref_mid}.conv.txt")
    else:
        assert results["t"] is None
    assert teval._SCRIPT.startswith(os.path.join(
        REPO_ROOT, "piano_a2s_tpu_torch", "train"))


def test_java_engine_evaluation_equals_jax(fake_bin, tmp_path,  # noqa: F811
                                           monkeypatch):
    """get_mv2h_from_test(engine="java") through the fake java: a scored
    clip, one the tool scores 0 and one whose target is missing give the
    same files in both packages."""
    monkeypatch.setenv("FAKE_JAVA_ZERO_FOR", "zeroclip")
    toks = LM.encode("4c 4c 4c 4c")
    root = str(tmp_path / "out")
    for clip_id in ("0~Song0.0~Upright", "1~zeroclip.0~YDP",
                    "2~brokenclip.0~Salamander"):
        _make_result_fixture(root, "test", clip_id,
                             [[0, "4/4", toks, toks]])
    os.remove(os.path.join(root, "2~brokenclip.0~Salamander_target.pkl"))
    a, b = _copies(root, str(tmp_path))
    errors_j = jeval.get_mv2h_from_test(a, "test", "/opt/MV2H/bin",
                                        timeout=600, engine="java")
    errors_t = teval.get_mv2h_from_test(b, "test", "/opt/MV2H/bin",
                                        timeout=600, engine="java")
    assert errors_t == errors_j == ["1~zeroclip.0~YDP",
                                    "2~brokenclip.0~Salamander"]
    assert _scored(b) == ["0~Song0.0~Upright_mv2h.json"]
    _assert_same_tree(os.path.join(a, "results"),
                      os.path.join(b, "results"))


@pytest.mark.parametrize("names,n_counted", [
    (["aclip", "bclip", "nanclip"], 2), (["aclip", "failclip"], 1)])
def test_external_muster_contract(tmp_path, monkeypatch, names, n_counted):
    """get_muster_er(engine="external") through the fake MUSTER: the same
    calls and rates as JAX's; a NaN row and a run that writes no ER.txt
    are skipped, never re-counted from the previous pair's file."""
    script, log = _install_fake_muster(tmp_path, monkeypatch)
    root = str(tmp_path / "out")
    _make_muster_fixture(root, names)
    got = {}
    for pkg, mod in (("j", jeval), ("t", teval)):
        ers, n = mod.get_muster_er(root, muster_script=script,
                                   engine="external")
        got[pkg] = ers, n, log.read_text()
        log.unlink()
    assert got["t"][1] == got["j"][1] == n_counted
    assert np.array_equal(got["t"][0], got["j"][0])
    np.testing.assert_allclose(got["t"][0], [0.1 * (i + 1)
                                             for i in range(11)], rtol=1e-6)
    assert got["t"][2] == got["j"][2]
    assert len(got["t"][2].splitlines()) == len(names)
    if "failclip" in names:
        assert not os.path.exists("ER.txt")


def test_external_muster_missing_tool_skips(tmp_path, monkeypatch):
    """Forced external without the tool: (zeros, 0) and the cwd's own
    ER.txt untouched, as in JAX."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "ER.txt").write_text("user's own file\n")
    root = str(tmp_path / "out")
    _make_muster_fixture(root, ["aclip"])
    for mod in (jeval, teval):
        ers, n = mod.get_muster_er(root, str(tmp_path / "missing.sh"),
                                   engine="external")
        assert n == 0 and not ers.any()
    assert (tmp_path / "ER.txt").read_text() == "user's own file\n"


# ---------------------------------------------------------------------------
# The evaluate command
# ---------------------------------------------------------------------------

CLI_CASES = {
    "native": ["--mv2h-engine", "native", "--muster", "--muster-engine",
               "native"],
    "fake_tools": ["--muster", "--muster-script", "{muster}"],
    "java_forced_missing": ["--mv2h-engine", "java"],
    "muster_external_missing": ["--muster", "--muster-engine", "external",
                                "--muster-script", "{missing}"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_evaluate_command_equals_jax(tmp_path, case):
    """python -m piano_a2s_tpu_torch.cli.evaluate and the root evaluate.py
    on two copies of one output folder: the same exit code and, with the
    folder's path replaced, the same standard output."""
    root = str(tmp_path)
    a, b = _copies(_write_results(root, 3), root)
    bindir = tmp_path / "fakebin"
    bindir.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    mv2h_bin = tmp_path / "MV2H" / "bin"
    muster = tmp_path / "evaluate_XML_voicePlus.sh"
    if case == "fake_tools":
        from test_external_tool_contracts import FAKE_JAVA
        (bindir / "java").write_text(FAKE_JAVA.format(python=sys.executable))
        (bindir / "java").chmod(0o755)
        env["PATH"] = f"{bindir}:{env['PATH']}"
        mv2h_bin.mkdir(parents=True)
        muster.write_text(FAKE_MUSTER.format(python=sys.executable))
        muster.chmod(0o755)
    flags = [f.format(muster=muster, missing=tmp_path / "missing.sh")
             for f in CLI_CASES[case]]
    runs = {}
    for pkg, out, command in (
            ("j", a, [os.path.join(REPO_ROOT, "evaluate.py")]),
            ("t", b, ["-m", "piano_a2s_tpu_torch.cli.evaluate"])):
        yaml_path = tmp_path / f"{pkg}.yaml"
        yaml_path.write_text(f"seed: 7\nworkspace: {root}\n"
                             f"output_folder: {out}\n"
                             f"feature_folder: {root}/features\n"
                             f"mv2h_bin: {mv2h_bin}\nmv2h_timeout: 120\n")
        r = subprocess.run([sys.executable, *command, str(yaml_path),
                            *flags], capture_output=True, text=True,
                           timeout=400, cwd=root, env=env)
        runs[pkg] = r.returncode, r.stdout.replace(out, "<OUT>"), r.stderr
    assert runs["t"][:2] == runs["j"][:2], (runs["t"], runs["j"])
    rc, stdout, _ = runs["t"]
    if case == "java_forced_missing":
        assert rc == 1
        assert stdout.startswith("error: --mv2h-engine java requested")
        return
    assert rc == 0, runs["t"]
    assert "<OUT>: MV2H export errors:" in stdout
    want = {"native": "MUSTER (native) ER over",
            "fake_tools": "MUSTER (external) ER over",
            "muster_external_missing": "skipping MUSTER"}[case]
    assert want in stdout
    if case != "muster_external_missing":
        _assert_same_tree(os.path.join(a, "results"),
                          os.path.join(b, "results"))


def test_evaluate_command_loads_no_jax(tmp_path):
    """The port's command, run in its own process, loads neither jax nor
    the JAX package, nor torch: it runs on the host only."""
    out = _write_results(str(tmp_path), 4)
    yaml_path = tmp_path / "eval.yaml"
    yaml_path.write_text(f"seed: 7\nworkspace: {tmp_path}\n"
                         f"output_folder: {out}\n"
                         f"feature_folder: {tmp_path}/features\n")
    code = ("import sys\n"
            "from piano_a2s_tpu_torch.cli.evaluate import main\n"
            f"rc = main([{str(yaml_path)!r}, '--mv2h-engine', 'native', "
            "'--muster', '--muster-engine', 'native'])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'piano_a2s_tpu'\n"
            "             or m.startswith('piano_a2s_tpu.'))\n"
            "print('RESULT', rc, bad, 'torch' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "RESULT 0 [] False" in r.stdout, r.stdout
    assert "MUSTER (native) ER over" in r.stdout


# ---------------------------------------------------------------------------
# The port Trainer's records
# ---------------------------------------------------------------------------

def _trainer_features(root, n_clips=4, seed=9):
    """A test split of n_clips: random spectrograms at the tiny width and
    2-bar chordal targets."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "test", "0")
    for sub in ("spectrogram", "target", "info"):
        os.makedirs(os.path.join(base, sub))
    for i in range(n_clips):
        chunk = f"{'Song' if i % 2 else 'song'}{i}.0"
        target, _ = draw_song_chordal(rng, n_bars=2)
        np.save(os.path.join(base, "spectrogram", f"{chunk}~v0~Upright.npy"),
                rng.rand(22, 16).astype(np.float32))
        with open(os.path.join(base, "target", f"{chunk}.pkl"), "wb") as f:
            pickle.dump(target, f)
        with open(os.path.join(base, "info", f"{chunk}.json"), "w") as f:
            json.dump({"composer": "synth"}, f)


@pytest.fixture(scope="module")
def trainer_records(tmp_path_factory):
    """The port Trainer's test stage (CPU, tiny width, random weights of
    seed 7) writes results/test/*.json."""
    root = str(tmp_path_factory.mktemp("records"))
    features = os.path.join(root, "features")
    _trainer_features(features)
    out = os.path.join(root, "run")
    exp = tconfig.ExperimentConfig(
        seed=7, workspace=root, output_folder=out, feature_folder=features,
        save_folder=os.path.join(out, "save"),
        train_log=os.path.join(out, "train_log.txt"), max_length=(64, 48),
        max_bars=2, max_duration=1, frames_per_second=23, bins_per_octave=4,
        n_octaves=4, batch_size=2, conv_feature_size=16, hidden_size=16,
        note_emb_size=8, staff_emb_size=8)
    trainer = tharness.Trainer(exp, device="cpu")
    test = tdata.SyntheticTestDataset(
        features, "test", versions=[0], max_frame_num=exp.max_frame_num,
        max_length=exp.max_length)
    trainer.evaluate(tdata.DataLoader(test, exp.batch_size))
    return out


@pytest.mark.parametrize("pred", ["model", "identity"])
def test_port_trainer_records_scored_by_both(trainer_records, tmp_path,
                                             pred):
    """Both evaluators score the port Trainer's records to the same files
    and numbers: as the model predicted them, and with each prediction
    replaced by the clip's own target (every clip then scores MV2H 1.0
    on every key and MUSTER 0)."""
    split_dir = os.path.join(trainer_records, "results", "test")
    records = sorted(os.listdir(split_dir))
    assert records == ["0~Song1.0~v0~Upright.json",
                       "0~Song3.0~v0~Upright.json",
                       "0~song0.0~v0~Upright.json",
                       "0~song2.0~v0~Upright.json"]
    a, b = _copies(trainer_records, str(tmp_path))
    if pred == "identity":
        for out in (a, b):
            for name in records:
                path = os.path.join(out, "results", "test", name)
                with open(path) as f:
                    record = json.load(f)
                with open(record["target_path"], "rb") as f:
                    record["pred"] = pickle.load(f)
                with open(path, "w") as f:
                    json.dump(record, f, indent=2)
    errors_j = jeval.get_mv2h_from_test(a, "test", "", engine="native")
    errors_t = teval.get_mv2h_from_test(b, "test", "", engine="native")
    assert errors_t == errors_j
    _assert_same_tree(os.path.join(a, "results"),
                      os.path.join(b, "results"))
    _assert_same_summaries(a, b)
    if pred == "identity":
        assert errors_t == []
        metrics, four_way, n = teval.summarize_syn_mv2h(b, split="test")
        assert n == 4 and four_way == 1.0
        assert all(v == 1.0 for v in metrics.values())
        ers, n_pairs = teval.get_muster_er(b, engine="native", split="test")
        assert n_pairs == 4 and not ers.any()


# ---------------------------------------------------------------------------
# The model self-test twin
# ---------------------------------------------------------------------------

def test_model_self_test_equals_jax(capsys):
    """python -m piano_a2s_tpu_torch.models --device cpu prints the JAX
    self-test's configuration, parameter count and output shapes."""
    assert jself_test.main([]) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    assert tself_test.main(["--device", "cpu"]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    assert len(port_lines) == len(jax_lines) == 5
    # The last line ends with the decoded lengths, which depend on the
    # random weights (the packages draw them differently).
    assert port_lines[:4] == jax_lines[:4]
    assert (port_lines[4].split("lengths:")[0]
            == jax_lines[4].split("lengths:")[0])
    assert "parameters: 193,619" in port_lines
