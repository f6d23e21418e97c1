"""The port's last modules against the JAX package on the CPU: the
Transcriber's spectrogram program and ``spectrogram()``, the three
diagnostic tools (``tools.frontend_ab``, ``tools.inspect_attention``,
``tools.load_test``) against scripts/frontend_ab.py,
scripts/inspect_attention.py and scripts/load_test.py, the utils surface
(``utils.io``, ``utils.sequences``) and the legacy vocabularies.

Inputs come from seeds (numpy). Tolerances: the spectrograms within 1e-5
(as test_get_vqt_matches_jax), the attention entropies within 1e-4; every
token, frame, count and report value equal."""

import glob
import importlib.util
import json
import os
import random
import sys
import threading

import numpy as np
import pytest
import torch

import jax

import piano_a2s_tpu.symbolic.humdrum as JH
import piano_a2s_tpu.symbolic.native as jnative
import piano_a2s_tpu.utils.io as jio
import piano_a2s_tpu_torch.utils as tutils
import piano_a2s_tpu_torch.utils.io as tio
from conftest import REPO_ROOT
from piano_a2s_tpu.config import ExperimentConfig as JExperimentConfig
from piano_a2s_tpu.data import DataLoader as JDataLoader
from piano_a2s_tpu.data import SyntheticTrainDataset as JTrainDataset
from piano_a2s_tpu.infer import Transcriber as JaxTranscriber
from piano_a2s_tpu.models import init_params, init_state
from piano_a2s_tpu.symbolic import vocab as jvocab
from piano_a2s_tpu.train.checkpoint import Checkpointer as JCheckpointer
from piano_a2s_tpu.train.harness import Trainer as JTrainer
from piano_a2s_tpu.utils import get_sequence_duration as j_duration
from piano_a2s_tpu_torch import infer as tinfer
from piano_a2s_tpu_torch import symbolic as tsymbolic
from piano_a2s_tpu_torch.config import ExperimentConfig as TExperimentConfig
from piano_a2s_tpu_torch.config import load_experiment as tload_experiment
from piano_a2s_tpu_torch.models.convert import state_dict_from_jax
from piano_a2s_tpu_torch.serve import make_server
from piano_a2s_tpu_torch.symbolic.export import split_sequence_bars
from piano_a2s_tpu_torch.tools import frontend_ab as tfrontend_ab
from piano_a2s_tpu_torch.tools import inspect_attention as tinspect
from piano_a2s_tpu_torch.tools import load_test as tload_test
from piano_a2s_tpu_torch.train.checkpoint import Checkpointer
from piano_a2s_tpu_torch.train.harness import Trainer as TTrainer
from test_harness_e2e import _make_fixture
from test_torch_infer import CFG, FRAMES, TCFG, TVQT, VQT

torch.set_num_threads(2)

ATOL_SPEC = 1e-5
ATOL_ENTROPY = 1e-4


def _script(name):
    """scripts/<name>.py of the JAX package, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO_ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _eos_biased_params(cfg, seed=0, bias=4.0):
    """Random JAX weights with the staves' EOS logit raised by ``bias`` (a
    decode that stops), as host numpy trees."""
    params = jax.tree.map(np.array, init_params(jax.random.PRNGKey(seed),
                                                cfg))
    for d in ("upper", "lower"):
        params["decoder"][d]["out"]["b"][cfg.eos] += bias
    return params, jax.tree.map(np.asarray, init_state(cfg))


# --- the spectrogram program -------------------------------------------------

@pytest.fixture(scope="module")
def transcribers():
    params, state = _eos_biased_params(CFG)
    jax_tr = JaxTranscriber(params, state, CFG, VQT, max_frame_num=FRAMES)
    port_tr = tinfer.Transcriber(state_dict_from_jax(params, state, TCFG),
                                 TCFG, TVQT, max_frame_num=FRAMES,
                                 device="cpu")
    return jax_tr, port_tr


def _clip(seed, n, int16):
    rng = np.random.RandomState(seed)
    if int16:
        return rng.randint(-3000, 3000, n).astype(np.int16)
    return (0.1 * rng.randn(n)).astype(np.float32)


# max_samples is 16000 at FRAMES = 101: shorter, equal, longer.
@pytest.mark.parametrize("n", [8000, 16000, 24000])
@pytest.mark.parametrize("int16", [False, True], ids=["float32", "int16"])
def test_spectrogram_matches_jax(transcribers, int16, n):
    jax_tr, port_tr = transcribers
    clip = _clip(n, n, int16)
    got, ref = port_tr.spectrogram(clip), np.asarray(jax_tr.spectrogram(clip))
    assert got.dtype == np.float32
    assert got.shape == ref.shape == (1, FRAMES, TVQT.n_bins)
    np.testing.assert_allclose(got, ref, atol=ATOL_SPEC, rtol=0)
    if n < port_tr.max_samples:  # zero past the frames the clip reaches
        assert not got[0, 1 + n // 160 + 4:].any()


@pytest.mark.parametrize("int16", [False, True], ids=["float32", "int16"])
def test_infer_spectrogram_matches_jax(transcribers, int16):
    jax_tr, port_tr = transcribers
    spec = np.concatenate([jax_tr.spectrogram(_clip(s, n, int16))
                           for s, n in ((1, 12000), (2, 16000))])[:, None]
    ref = jax.device_get(jax_tr._infer(jax_tr.params, jax_tr.state, spec))
    for tensor_input in (False, True):
        arg = torch.from_numpy(spec) if tensor_input else spec
        got = port_tr._to_host(port_tr._infer_spectrogram(arg))
        assert len(got) == len(ref) == 6
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("int16", [False, True], ids=["float32", "int16"])
def test_infer_audio_is_frontend_then_spectrogram(transcribers, int16):
    _, port_tr = transcribers
    audio = np.stack([port_tr._prep_audio(_clip(s, n, int16))
                      for s, n in ((3, 9000), (4, 20000))])
    spec = port_tr._frontend(audio)
    assert spec.shape == (2, 1, FRAMES, TVQT.n_bins)
    got = port_tr._to_host(port_tr._infer_audio(audio))
    ref = port_tr._to_host(port_tr._infer_spectrogram(spec))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


# --- inspect_attention -------------------------------------------------------

TINY = dict(seed=7, max_length=(8, 6), max_bars=2, max_duration=1,
            frames_per_second=23, bins_per_octave=4, n_octaves=4,
            number_of_epochs=1, batch_size=2, conv_feature_size=16,
            hidden_size=16, note_emb_size=8, staff_emb_size=8)


def _exp(mod, root, features, name, **extras):
    out = os.path.join(root, name)
    exp = mod(workspace=root, output_folder=out, feature_folder=features,
              save_folder=os.path.join(out, "save"),
              train_log=os.path.join(out, "train_log.txt"), **TINY)
    exp.extras.update(extras)
    return exp


def _attention_setting(root, features, **extras):
    """A JAX Trainer, the port's Trainer on its weights, and the first
    batch of 3 of ``features``'s train split, collated by the JAX DataLoader
    and bucketed."""
    jtrainer = JTrainer(_exp(JExperimentConfig, root, features, "jax",
                             **extras))
    exp_t = _exp(TExperimentConfig, root, features, "port", **extras)
    ttrainer = TTrainer(exp_t, device="cpu", state_dict=state_dict_from_jax(
        jax.tree.map(np.asarray, jtrainer.params),
        jax.tree.map(np.asarray, jtrainer.state), exp_t.model_config()))
    ds = JTrainDataset(features, "train", versions=range(1),
                       rng=np.random.RandomState(7),
                       **jtrainer.exp.dataset_kwargs())
    batch = next(iter(JDataLoader(ds, batch_size=3, shuffle=False, seed=0)))
    batch, _ = jtrainer._bucketed(batch)
    return jtrainer, ttrainer, batch


@pytest.fixture(scope="module")
def attention_run(tmp_path_factory):
    """The setting on the tiny spectrogram corpus (test_harness_e2e's).
    The spectrograms are scaled by 10: unit-scale random spectrograms leave
    this small model's conv features all zero."""
    root = str(tmp_path_factory.mktemp("attention"))
    features = os.path.join(root, "features")
    _make_fixture(features, "train", 0, n_songs=3)
    jtrainer, ttrainer, batch = _attention_setting(root, features)
    batch["spectrogram"] = batch["spectrogram"] * np.float32(10.0)
    return jtrainer, ttrainer, batch


@pytest.fixture(scope="module")
def audio_attention_run(tmp_path_factory):
    """The setting from audio: int16 clips of 2500-3800 samples
    (train/synthetic.py::write_clips) and each package's audio frontend,
    which also gives the expected frames their content share."""
    from piano_a2s_tpu.train.step import make_audio_frontend as j_frontend
    from piano_a2s_tpu_torch.train.step import (
        make_audio_frontend as t_frontend)
    from piano_a2s_tpu_torch.train.synthetic import write_clips

    root = str(tmp_path_factory.mktemp("attention_audio"))
    features = os.path.join(root, "features")
    write_clips(os.path.join(features, "train", "0"), 3, seed=5,
                samples=(2500, 3800), upper=(1, 7), lower=(1, 5), bars=2)
    jtrainer, ttrainer, batch = _attention_setting(
        root, features, input_features="audio")
    exp = ttrainer.exp
    return (jtrainer, ttrainer, batch,
            j_frontend(exp.vqt_config(), exp.max_frame_num),
            t_frontend(exp.vqt_config(), exp.max_frame_num, device="cpu"))


@pytest.mark.parametrize("source", ["spectrogram", "audio"])
@pytest.mark.parametrize("staff", ["upper", "lower"])
@pytest.mark.parametrize("bar", [0, 1])
def test_inspect_attention_matches_jax(request, source, bar, staff):
    if source == "audio":
        jtrainer, ttrainer, batch, j_prep, t_prep = request.getfixturevalue(
            "audio_attention_run")
    else:
        jtrainer, ttrainer, batch = request.getfixturevalue("attention_run")
        j_prep = t_prep = None
    j_lines, t_lines = [], []
    ref = _script("inspect_attention").inspect_attention(
        jtrainer, batch, prep=j_prep, bar=bar, clip=1, staff=staff,
        out=j_lines.append)
    got = tinspect.inspect_attention(ttrainer, batch, prep=t_prep, bar=bar,
                                     clip=1, staff=staff,
                                     out=t_lines.append)
    assert len(got) == len(ref) == int(batch[f"{staff}_lengths"][1, bar])
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in ("step", "argmax_frame", "expected_frame", "gt", "pred"):
            assert g[k] == r[k], (g["step"], k)
        assert abs(g["entropy"] - r["entropy"]) <= ATOL_ENTROPY
    assert t_lines[0] == j_lines[0] and len(t_lines) == len(j_lines)
    assert ttrainer.model.training  # left as it was found


def test_inspect_attention_staff_summaries_start_token(attention_run):
    """The bar-level start token: JAX tiles [<sos>, <eos>] of length 2
    through _staff_summary; the port's sos_token packs the same."""
    import piano_a2s_tpu.models.score_transcription as JM
    from piano_a2s_tpu.ops import layers as JL
    jtrainer, ttrainer, _ = attention_run
    cfg, dec = jtrainer.cfg, jtrainer.params["decoder"]
    sos_pair = np.tile(np.array([[cfg.sos, cfg.eos]], np.int32), (3, 1))
    staff0 = JM._staff_summary(dec, sos_pair, np.full((3,), 2, np.int32))
    time0 = JL.embed(dec["time_sig_emb"], np.full((3,), cfg.num_time_sig))
    key0 = JL.embed(dec["key_emb"], np.full((3,), cfg.num_keys))
    ref = np.concatenate([staff0, staff0, time0, key0], axis=-1)
    with torch.inference_mode():
        got = ttrainer.model.decoder.sos_token(3, torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_inspect_attention_main_matches_jax(attention_run, tmp_path, capsys):
    """Both commands on checkpoints of the same weights (the JAX Trainer's
    save and the port's Checkpointer), one YAML: the same printed lines,
    apart from the entropies' last digit."""
    jtrainer, ttrainer, _ = attention_run
    exp = jtrainer.exp
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text("".join(
        f"{k}: {list(v) if isinstance(v, tuple) else v}\n"
        for k, v in TINY.items())
        + f"workspace: {tmp_path}\noutput_folder: {tmp_path}/out\n"
          f"train_log: {tmp_path}/out/log.txt\n")
    jsave, tsave = str(tmp_path / "jax_save"), str(tmp_path / "port_save")
    JCheckpointer(jsave).save(jtrainer._trees(), {"WER": 1.0},
                              jtrainer._host_state(1))
    Checkpointer(tsave).save(ttrainer._trees(), {"WER": 1.0},
                             ttrainer._host_state(1))
    args = ["--config", str(yaml), "--feature-folder", exp.feature_folder,
            "--clip", "1", "--bar", "1", "--staff", "lower"]
    capsys.readouterr()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["inspect_attention.py"])
        _script("inspect_attention").main(["--checkpoint", jsave] + args)
    j_out = capsys.readouterr().out.splitlines()
    rows = tinspect.main(["--checkpoint", tsave, "--device", "cpu"] + args)
    t_out = capsys.readouterr().out.splitlines()
    assert len(rows) == len(t_out) - 2 == len(j_out) - 2 > 0
    assert t_out[:2] == j_out[:2]
    for t, j in zip(t_out[2:], j_out[2:]):
        (ts, te, ta, tx), (js, je, ja, jx) = t.split(), j.split()
        assert (ts, ta, tx) == (js, ja, jx)
        assert abs(float(te) - float(je)) <= 0.01


# --- frontend_ab -------------------------------------------------------------

@pytest.fixture(scope="module")
def ab_setup(tmp_path_factory):
    """tests/test_frontend_ab.py's setting: a 2-song corpus with audio and a
    small model over the full 480 bins. Returns (folder, YAML, save) with
    ``save(bias)`` writing the EOS-biased random weights by the JAX
    Checkpointer and the same weights by the port's."""
    from piano_a2s_tpu.config import load_experiment
    from piano_a2s_tpu.data.synth import write_corpus
    from piano_a2s_tpu.train.step import make_optimizer

    tmp = tmp_path_factory.mktemp("ab")
    cfg_yaml = tmp / "tiny.yaml"
    cfg_yaml.write_text(
        "seed: 0\nmidi_syn: score\nworkspace: {0}\n"
        "output_folder: {0}/out\nfeature_folder: {0}/features\n"
        "save_folder: {0}/out/save\ntrain_log: {0}/out/log.txt\n"
        "max_length: [64, 64]\nmax_bars: 2\nbins_per_octave: 60\n"
        "n_octaves: 8\nconv_feature_size: 16\nhidden_size: 16\n"
        "note_emb_size: 8\nstaff_emb_size: 8\nnumber_of_epochs: 1\n"
        "batch_size: 2\n".format(tmp))
    write_corpus(str(tmp / "features"), "test", 2, seed=3, n_bars=2,
                 frontend="direct")
    cfg = load_experiment(str(cfg_yaml)).model_config()
    tcfg = tload_experiment(str(cfg_yaml)).model_config()

    def save(bias):
        params, state = _eos_biased_params(cfg, bias=bias)
        jax_save = str(tmp / f"jax_save_{bias}")
        JCheckpointer(jax_save).save(
            {"params": params, "state": state,
             "opt_state": make_optimizer().init(params)},
            meta={"WER": 1.0}, host_state={"epoch": 1})
        port_save = str(tmp / f"port_save_{bias}")
        Checkpointer(port_save).save(
            {"model": state_dict_from_jax(params, state, tcfg)},
            {"WER": 1.0}, {"epoch": 1})
        return jax_save, port_save

    return tmp, str(cfg_yaml), save


# The recipe's EOS bias of 4 stops every staff at once (no token is
# compared); without it, and below it, the staves emit tokens.
@pytest.mark.parametrize("bias", [4.0, 0.0, -3.0])
def test_frontend_ab_report_matches_jax(ab_setup, bias, capsys):
    tmp, cfg_yaml, save = ab_setup
    jax_save, port_save = save(bias)
    features = str(tmp / "features")
    j_json, t_json = str(tmp / "jax.json"), str(tmp / "port.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["frontend_ab.py", jax_save, features,
                                 "--config", cfg_yaml, "--out", j_json,
                                 "--platform", "cpu"])
        _script("frontend_ab").main()
    report = tfrontend_ab.main([port_save, features, "--config", cfg_yaml,
                                "--out", t_json, "--device", "cpu"])
    out = capsys.readouterr().out
    with open(j_json) as f:
        ref = json.load(f)
    with open(t_json) as f:
        got = json.load(f)
    assert got == report
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k] == v, k
    assert got["clips"] == 2
    assert (got["upper_tokens_compared"] > 0) == (bias < 4)
    assert json.dumps(got, indent=2) in out


def test_frontend_ab_without_audio_exits(ab_setup, tmp_path):
    _, cfg_yaml, save = ab_setup
    port_save = save(4.0)[1]
    with pytest.raises(SystemExit, match="must carry raw audio"):
        tfrontend_ab.main([port_save, str(tmp_path), "--config", cfg_yaml,
                           "--device", "cpu"])


@pytest.mark.parametrize("tool", ["frontend_ab", "inspect_attention"])
def test_tools_ask_for_the_card_and_raise_without_it(ab_setup, tool,
                                                     monkeypatch):
    tmp, cfg_yaml, save = ab_setup
    port_save = save(4.0)[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if tool == "frontend_ab":
            tfrontend_ab.main([port_save, str(tmp / "features"),
                               "--config", cfg_yaml])
        else:
            tinspect.main(["--checkpoint", port_save, "--config", cfg_yaml,
                           "--feature-folder", str(tmp / "features")])


# --- load_test ---------------------------------------------------------------

@pytest.fixture(scope="module")
def server(transcribers):
    _, port_tr = transcribers
    httpd = make_server(port_tr, "127.0.0.1", 0, max_batch=4,
                        max_wait_ms=20)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.service.close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _stats(url):
    import urllib.request
    with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
        return json.load(r)


@pytest.mark.parametrize("which", ["port", "jax_script"])
def test_load_test_against_the_port_server(server, which, capsys,
                                           monkeypatch):
    before = _stats(server)["clips"]
    argv = ["--url", server, "--clients", "4", "--clips", "8",
            "--seconds", "1", "--seed", "3"]
    capsys.readouterr()
    if which == "port":
        rc = tload_test.main(argv)
    else:
        monkeypatch.setattr(sys, "argv", ["load_test.py"] + argv)
        rc = _script("load_test").main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert (line["ok"], line["errors"], line["clips"]) == (8, 0, 8)
    assert line["server_stats"]["clips"] == before + 8
    assert _stats(server)["clips"] == before + 8


def test_load_test_copy_differs_only_as_documented():
    """The copy's body is the script's: the WAV writer is byte-equal and
    its options are the same."""
    script = _script("load_test")
    audio = _clip(9, 4000, False)
    assert tload_test.wav_bytes(audio, 16000) == script.wav_bytes(audio,
                                                                  16000)
    with pytest.raises(SystemExit):
        tload_test.main(["--help"])


# --- utils -------------------------------------------------------------------

_DATA = {".npy": np.arange(12, dtype=np.float32).reshape(3, 4),
         ".json": {"a": [1, 2.5, "x"], "b": None},
         ".yaml": {"lr": 1.0, "names": ["x", "y"]},
         ".pkl": {"t": (1, 2), "s": "kern"},
         ".txt": ["one", "two", "three"]}


@pytest.mark.parametrize("ext", sorted(_DATA))
def test_io_round_trips_byte_equal_to_jax(ext, tmp_path):
    data = _DATA[ext]
    t_path, j_path = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    tutils.save(data, t_path)
    jio.save(data, j_path)
    assert open(t_path, "rb").read() == open(j_path, "rb").read()
    got, ref = tutils.load(t_path), jio.load(j_path)
    if ext == ".npy":
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(ref, data)
    else:
        assert got == ref == data


def test_io_helpers_match_jax(tmp_path):
    csv = tmp_path / "m.csv"
    csv.write_text("h1,h2\n1,2\n3,4\n")
    assert tio.load(str(csv)) == jio.load(str(csv))
    with pytest.raises(ValueError):
        tio.load(str(tmp_path / "x.bin"))
    with pytest.raises(ValueError):
        tio.save([1], str(tmp_path / "x.bin"))
    tutils.mkdirs([str(tmp_path / "a" / "b"), str(tmp_path / "c")])
    assert (tmp_path / "a" / "b").is_dir() and (tmp_path / "c").is_dir()
    (tmp_path / "a" / "b" / "f.txt").write_text("x")
    assert tio.traverse_folder(str(tmp_path / "a")) == jio.traverse_folder(
        str(tmp_path / "a"))
    assert tio.get_filename("/x/y/z.tar.npy") == jio.get_filename(
        "/x/y/z.tar.npy")
    for n in (3, 6):
        np.testing.assert_array_equal(
            tio.pad_truncate_sequence([1, 2, 3, 4], n),
            jio.pad_truncate_sequence([1, 2, 3, 4], n))
    d_t, d_j = {}, {}
    for k, v in (("a", 1), ("b", 2), ("a", 3)):
        tio.append_to_dict(d_t, k, v)
        jio.append_to_dict(d_j, k, v)
    assert d_t == d_j
    tutils.set_seed(5)
    draw = (random.random(), np.random.rand())
    jio.set_seed(5)
    assert draw == (random.random(), np.random.rand())


KERN = sorted(glob.glob(os.path.join(REPO_ROOT, "tests", "fixtures", "kern",
                                     "*.krn")))


@pytest.mark.parametrize("path", KERN,
                         ids=[os.path.basename(p)[:-4] for p in KERN])
def test_sequence_duration_matches_jax(path):
    """Each bar of both staves of the kern fixtures, tokenized as the data
    preparation does (process_voices, sort_chords, sort_voices,
    tosequence, split_sequence_bars, LabelsMultiple.encode)."""
    with open(path, encoding="iso-8859-1") as f:
        text = f.read()
    labels = tsymbolic.LabelsMultiple(extended=True)
    bars = 0
    for spine in (1, 2):
        stave = jnative.extract_spine(text, spine)
        seq = JH.sort_voices(JH.sort_chords(JH.process_voices(
            JH.Kern(data=stave)))).tosequence()
        for bar in split_sequence_bars(seq):
            tokens = labels.encode(bar)
            got = tutils.get_sequence_duration(tokens)
            assert got == j_duration(tokens) > 0
            assert tutils.get_sequence_duration(
                tokens + [labels.labels_map["<eos>"], 9]) == got
            bars += 1
    assert bars >= 20


@pytest.mark.parametrize("name,kwargs", [
    ("Labels", {}), ("LabelsSingle", {}),
    ("LabelsSingle", {"extended": True}),
    ("LabelsMultiple", {"extended": True})])
def test_vocabularies_match_jax(name, kwargs):
    got, ref = getattr(tsymbolic, name)(**kwargs), getattr(jvocab, name)(
        **kwargs)
    assert got.labels == ref.labels
    assert got.labels_map == ref.labels_map
    assert got.labels_map_inv == ref.labels_map_inv
    rng = np.random.RandomState(len(ref.labels))
    for _ in range(20):
        seq = rng.randint(0, len(ref.labels) + 3, rng.randint(0, 30)).tolist()
        assert got.decode(seq) == ref.decode(seq)
        if name == "Labels":
            assert got.ctclen(seq) == ref.ctclen(seq)
            chars = [ref.labels[i % len(ref.labels)] for i in seq]
            assert got.encode(chars) == ref.encode(chars)
    if name == "LabelsSingle":
        text = "4c\t8.dd\n2r\t[4e"
        assert got.encode(text) == ref.encode(text)


def test_vocabularies_sizes():
    assert len(tsymbolic.Labels().labels) == 38
    assert len(tsymbolic.LabelsSingle().labels) == 9146
    assert len(tsymbolic.LabelsSingle(extended=True).labels) == 13631
    assert tsymbolic.Labels().ctclen([1, 1, 2, 2, 2]) == 8
