"""The port's score side of the data preparation against the JAX package on
the CPU: the audio effects, the synthesis stages (split, midi, clean,
convert, preprocess, render), the ASAP processing, the EPR adapters and the
prepare_data command.

Each stage runs over the same inputs into two trees, one for each package,
and every file each writes must be byte-equal to the other's. External
tools are the fake binaries of tests/test_external_tool_contracts.py
(verovio, FluidSynth) or chip_smoke.py's stand-in synthesizer; the EPR
engine is the native one."""

import json
import os
import shutil
import stat
import sys
import textwrap

import numpy as np
import pytest

import chip_smoke
import piano_a2s_tpu.data.audio_fx as jfx
import piano_a2s_tpu.data.render as jrender
import piano_a2s_tpu_torch.data.audio_fx as tfx
import piano_a2s_tpu_torch.data.render as trender
import prepare_data as jprepare
from conftest import REPO_ROOT
from piano_a2s_tpu.data.asap import ProcessASAP as JProcessASAP
from piano_a2s_tpu.data.epr_native import \
    make_native_epr_generator as j_native_epr
from piano_a2s_tpu_torch.cli import prepare_data as tprepare
from piano_a2s_tpu_torch.data import epr as tepr
from piano_a2s_tpu_torch.data.asap import (ProcessASAP,
                                           drop_opening_barline,
                                           parse_annotation_downbeats)
from piano_a2s_tpu_torch.data.datasets import load_split_list
from piano_a2s_tpu_torch.data.epr_native import \
    make_native_epr_generator as t_native_epr
from piano_a2s_tpu_torch.symbolic.humdrum import Kern
from piano_a2s_tpu_torch.utils.audio import read_wav, write_wav
# pytest picks up `fake_bin` through this import.
from test_external_tool_contracts import _write_test_midi, fake_bin  # noqa: F401
from test_pipeline import _long_score
from test_torch_features import _assert_trees_equal

FIXTURES = os.path.join(REPO_ROOT, "tests", "fixtures", "kern")
TEST_SONG = load_split_list("test_split.txt")[1]
VALID_SONG = load_split_list("valid_split.txt")[1]


def _sine_wav(path, seconds, rate=16000, freq=440.0):
    t = np.arange(int(seconds * rate)) / rate
    write_wav(str(path), 0.5 * np.sin(2 * np.pi * freq * t), rate)


def _kern_folder(path):
    """The four real-score excerpts, the first renamed into the test split
    and the second into the valid split."""
    os.makedirs(path)
    names = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".krn"))
    for i, name in enumerate(names):
        dst = {0: f"{TEST_SONG}.krn", 1: f"{VALID_SONG}.krn"}.get(i, name)
        shutil.copy(os.path.join(FIXTURES, name), os.path.join(path, dst))
    return str(path)


def test_metadata_lists_are_copies():
    src = os.path.join(REPO_ROOT, "piano_a2s_tpu", "data", "metadata")
    dst = os.path.join(REPO_ROOT, "piano_a2s_tpu_torch", "data", "metadata")
    names = sorted(os.listdir(src))
    assert sorted(os.listdir(dst)) == names
    for name in names:
        with open(os.path.join(src, name), "rb") as f, \
                open(os.path.join(dst, name), "rb") as g:
            assert f.read() == g.read(), name


# --- the audio effects -------------------------------------------------------

def _audio(seconds, rate, seed, amp=0.3):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    y = amp * np.sin(2 * np.pi * 220 * t) * np.exp(-t) \
        + 0.05 * rng.randn(len(t))
    return y * (1 + 3 * (t > seconds / 2))  # a loud second half


@pytest.mark.parametrize("fn", [
    "k_weight", "integrated_loudness", "peak_normalize",
    "loudness_normalize", "compressor", "normalize_rendered_audio",
    "normalize_quiet", "stereo"])
def test_audio_fx_equal_to_jax(fn):
    rate = 44100
    y = _audio(1.5, rate, seed=3)
    calls = {
        "k_weight": lambda m: m.k_weight(y, rate),
        "integrated_loudness": lambda m: m.integrated_loudness(y, rate),
        "peak_normalize": lambda m: m.peak_normalize(y, -3.0),
        "loudness_normalize": lambda m: m.loudness_normalize(y, -23.0,
                                                             -15.0),
        "compressor": lambda m: m.Compressor(-12, 6, 5, 80)(y, rate),
        "normalize_rendered_audio": lambda m: m.normalize_rendered_audio(
            y, rate, m.Compressor(threshold_db=-1, ratio=18, attack_ms=50)),
        "normalize_quiet": lambda m: m.normalize_rendered_audio(
            _audio(1.0, 16000, 4, amp=0.002), 16000),
        "stereo": lambda m: m.normalize_rendered_audio(
            np.stack([y, _audio(1.5, rate, 5)], 1), rate),
    }
    got, want = calls[fn](tfx), calls[fn](jfx)
    assert type(got) is type(want)
    if isinstance(want, tuple):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    else:
        np.testing.assert_array_equal(got, want)


# --- the kern-side stages -----------------------------------------------------

# Key and time signatures changing at a barline, and a final '=='.
SIGNATURE_CHANGES = (
    "**kern\t**kern\n*k[f#]\t*k[f#]\n*M4/4\t*M4/4\n=1\t=1\n4c\t4e\n"
    "=2\t=2\n*M3/4\t*M3/4\n*k[b-e-]\t*k[b-e-]\n4d\t4f\n=3\t=3\n=4\t=4\n"
    "2G\t2g\n==\t==\n*-\t*-\n")


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(FIXTURES) if f.endswith(".krn")) + ["changes"])
def test_signature_helpers_equal_to_jax(name):
    if name == "changes":
        text = SIGNATURE_CHANGES
    else:
        with open(os.path.join(FIXTURES, name), encoding="iso-8859-1") as f:
            text = f.read()
    for fn in ("get_staff_spines", "measure_signatures", "count_measures"):
        assert getattr(trender, fn)(text) == getattr(jrender, fn)(text)


def test_tables_equal_to_jax():
    """The transposition, soundfont and composer tables, and the native EPR
    engine's style table: the stages draw from them with one RandomState,
    and a few chunks cannot show every entry."""
    import piano_a2s_tpu.data.epr_native as jepr_native
    import piano_a2s_tpu_torch.data.epr_native as tepr_native
    for name in ("FEASIBLE_TRANSPOSES", "TRAIN_SOUNDFONTS", "TEST_SOUNDFONTS",
                 "TRAIN_COMPOSERS", "TEST_COMPOSERS"):
        assert getattr(trender, name) == getattr(jrender, name), name
    assert tepr_native._STYLE == jepr_native._STYLE


def _split_midi_clean(R, gen, root, kern):
    R.split_datasets([0, 1], root, kern_folder=kern, seed=3)
    R.xml_to_midi([0, 1], root, midi_syn="epr", seed=3, epr_generate=gen)
    # A MIDI whose clip breaks clean_files' rules: it has no target.
    _write_test_midi(os.path.join(root, "train", "0", "midi", "stray.mid"))
    return R.clean_files([0, 1], root)


def test_split_midi_clean_equal_to_jax(tmp_path):
    """split_datasets, xml_to_midi with the native EPR engine (valid/0 and
    test/0 copied to versions 1-3, the composers drawn in the same order)
    and clean_files over the real-score excerpts, into two trees."""
    kern = _kern_folder(tmp_path / "kern")
    roots = [str(tmp_path / n) for n in ("jax", "port")]
    n_j = _split_midi_clean(jrender, j_native_epr(str(tmp_path / "js")),
                            roots[0], kern)
    n_t = _split_midi_clean(trender, t_native_epr(str(tmp_path / "ts")),
                            roots[1], kern)
    assert n_t == n_j >= 1
    names = _assert_trees_equal(*roots)
    assert not any("stray" in n for n in names)
    for split in ("train/0", "train/1", "valid/0", "valid/1", "test/0",
                  "test/1"):
        assert any(n.startswith(f"{split}/midi/") for n in names), split
    for v in (2, 3):  # copied, but versions [0, 1] render no MIDI there
        assert any(n.startswith(f"test/{v}/target/") for n in names)
        assert not any(n.startswith(f"test/{v}/midi/") for n in names)
    with open(os.path.join(roots[1], "test", "1", "info",
                           f"{TEST_SONG}.0.json")) as f:
        assert json.load(f)["composer"] == "Bach"


def test_xml_to_midi_score_equal_to_jax(fake_bin, tmp_path,  # noqa: F811
                                        monkeypatch):
    """midi_syn='score' through verovio (fake), MIDIProcess's tempo
    augmentation on the same RandomState."""
    midi = tmp_path / "fixture.mid"
    _write_test_midi(midi, n_beats=12)
    monkeypatch.setenv("FAKE_VEROVIO_MIDI", str(midi))
    kern = _kern_folder(tmp_path / "kern")
    roots = [str(tmp_path / n) for n in ("jax", "port")]
    for R, root in zip((jrender, trender), roots):
        R.split_datasets([0], root, kern_folder=kern, seed=5)
        R.xml_to_midi([0], root, midi_syn="score", seed=5)
    names = _assert_trees_equal(*roots)
    assert sum(n.startswith("train/0/midi/") for n in names) >= 4
    with pytest.raises(RuntimeError, match="requires virtuosoNet"):
        trender.xml_to_midi([0], roots[1], midi_syn="epr")


def test_convert_and_preprocess_equal_to_jax(fake_bin, tmp_path,  # noqa: F811
                                             monkeypatch):
    """convert_xml_to_kern (verovio) and preprocess_kern: the Chopin filter
    by selected_chopin.txt, joplin#school dropped, the other Joplin scores
    re-normalized through hum2xml and verovio (fakes), one hum2xml
    failure."""
    hum2xml = fake_bin / "hum2xml"
    hum2xml.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        if "broken" in sys.argv[1]:
            sys.exit(1)
        print("<score-partwise/>")
        """))
    hum2xml.chmod(hum2xml.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("FAKE_VEROVIO_HUM", os.path.join(
        FIXTURES, "mozart_k545_i_excerpt.krn"))
    chopin = load_split_list("selected_chopin.txt")[1]
    xml_names = [f"chopin#{chopin}", "chopin#not_selected", "joplin#school",
                 "joplin#maple", "joplin#broken", "mozart#k545"]
    roots = []
    for name, R in (("jax", jrender), ("port", trender)):
        xml = tmp_path / name / "xml"
        xml.mkdir(parents=True)
        for x in xml_names:
            (xml / f"{x}.xml").write_text("<score-partwise/>")
        (xml / "notes.txt").write_text("not xml")
        kern = str(tmp_path / name / "kern")
        assert R.convert_xml_to_kern(str(xml), kern) == len(xml_names)
        R.preprocess_kern(kern)
        roots.append(kern)
    names = _assert_trees_equal(*roots)
    assert names == sorted([f"chopin#{chopin}.krn", "joplin#maple.krn",
                            "mozart#k545.krn"])


def test_render_all_midi_equal_to_jax(fake_bin, tmp_path,  # noqa: F811
                                      monkeypatch):
    """The fake FluidSynth's WAV through the compressor and loudness loop,
    the soundfonts drawn from the same RandomState."""
    wav = tmp_path / "fixture.wav"
    _sine_wav(wav, 1.0, rate=44100)
    monkeypatch.setenv("FAKE_FLUIDSYNTH_WAV", str(wav))
    roots = []
    for name, R in (("jax", jrender), ("port", trender)):
        root = tmp_path / name
        for split, n in (("train", 3), ("valid", 1), ("test", 1)):
            mdir = root / split / "0" / "midi"
            mdir.mkdir(parents=True)
            for i in range(n):
                _write_test_midi(mdir / f"song{i}.mid", n_beats=4)
        R.render_all_midi([0], str(root), "/sf", seed=9)
        roots.append(str(root))
    names = _assert_trees_equal(*roots)
    assert sum(n.endswith(".wav") for n in names) == 3 + 1 + 3


def test_standin_synthesizer_renders_each_soundfont(tmp_path, monkeypatch):
    """chip_smoke.py's stand-in FluidSynth through render_one_midi of both
    packages: the same bytes, and a different timbre for each test
    soundfont."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "fluidsynth"
    exe.write_text(chip_smoke.FLUIDSYNTH_STANDIN.format(
        python=sys.executable, repo=REPO_ROOT))
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    midi = tmp_path / "in.mid"
    _write_test_midi(midi, n_beats=6)
    outs = []
    for font in trender.TEST_SOUNDFONTS:
        pair = []
        for R in (jrender, trender):
            wav = tmp_path / f"{R.__name__}~{font[:-4]}.wav"
            assert R.render_one_midi(str(midi), str(wav), f"/sf/{font}",
                                     16000)
            pair.append(wav.read_bytes())
        assert pair[0] == pair[1]
        outs.append(read_wav(str(wav))[0])
    assert all(len(o) == len(outs[0]) > 16000 for o in outs)
    assert not np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[1], outs[2])


# --- ASAP ---------------------------------------------------------------------

ASAP_YAML = """\
seed: 11
midi_syn: score
workspace: {root}
feature_folder: {root}/{name}_features
asap_folder: {root}/asap
"""


def _asap_checkout(root, monkeypatch):
    """A fake ASAP checkout: one matching performance, one whose
    annotations do not match the score."""
    song = root / "asap" / "asap-dataset" / "Bach" / "Prelude" / "bwv_862"
    song.mkdir(parents=True)
    (song / "xml_score.musicxml").write_text("<score/>")
    score = _long_score(12)
    kern = root / "score.krn"
    kern.write_text(score)
    monkeypatch.setenv("FAKE_VEROVIO_HUM", str(kern))
    from piano_a2s_tpu_torch.symbolic.humdrum import count_measure_segments
    n = count_measure_segments("\n".join(Kern(data=score).body))
    (song / "perf1_annotations.txt").write_text(
        "".join(f"{t}.0\t{t}.0\tdb,4/4,1\n" for t in range(n)))
    _sine_wav(song / "perf1.wav", n + 1.0)
    (song / "perf2_annotations.txt").write_text(
        "0.0\t0.0\tdb,4/4,1\n1.0\t1.0\tdb,4/4,1\n")
    _sine_wav(song / "perf2.wav", 3.0)


def test_process_asap_equal_to_jax(fake_bin, tmp_path,  # noqa: F811
                                   monkeypatch):
    _asap_checkout(tmp_path, monkeypatch)
    asap = str(tmp_path / "asap")
    roots = [str(tmp_path / n) for n in ("jax", "port")]
    got = [P(asap, root).process_all()
           for P, root in zip((JProcessASAP, ProcessASAP), roots)]
    assert got[0] == got[1] == ["Bach#Prelude#bwv_862#perf2"]
    names = _assert_trees_equal(*roots)
    specs = [n for n in names if n.startswith("train/spectrogram/")]
    assert specs and len(specs) == sum(
        n.startswith("train/target/") for n in names)


def test_asap_helpers_equal_to_jax():
    import piano_a2s_tpu.data.asap as jasap
    import piano_a2s_tpu.symbolic.humdrum as JH
    anno = ["0.0\t0.0\tb,3/4,-2", "0.5\t0.5\tdb", "1.0\t1.0\tb,,",
            "2.0\t2.0\tdb,4/4,1", "3.0\t3.0\tdb"]
    assert parse_annotation_downbeats(anno) == \
        jasap.parse_annotation_downbeats(anno)
    text = "**kern\n*M4/4\n=1-\n4c\n=2\n4d\n*-\n"
    assert drop_opening_barline(Kern(data=text)).dump() == \
        jasap.drop_opening_barline(JH.Kern(data=text)).dump()


# --- the EPR adapter (virtuosoNet) ---------------------------------------------

_FAKE_MODEL_RUN = textwrap.dedent("""\
    import json, os, shutil

    def load_file_and_generate_performance(path_name, composer):
        assert os.path.isfile(os.path.join(path_name, "xml.xml"))
        os.makedirs("test_result", exist_ok=True)
        shutil.copy(os.environ["FAKE_EPR_MIDI"],
                    os.path.join("test_result", "epr_by_isgn_z0.mid"))
        with open("call_log.json", "w") as f:
            json.dump({"path_name": path_name, "composer": composer,
                       "cwd": os.getcwd()}, f)
    """)


@pytest.fixture()
def fake_checkout(tmp_path, monkeypatch):
    root = tmp_path / "virtuosoNet"
    root.mkdir()
    (root / "model_run.py").write_text(_FAKE_MODEL_RUN)
    midi = tmp_path / "performance.mid"
    _write_test_midi(midi, n_beats=14)
    monkeypatch.setenv("FAKE_EPR_MIDI", str(midi))
    monkeypatch.delenv("VIRTUOSONET_PATH", raising=False)
    return str(root)


def test_epr_adapter_contract(fake_checkout, tmp_path, monkeypatch):
    assert tepr.find_virtuosonet(fake_checkout) == fake_checkout
    with pytest.raises(RuntimeError):
        tepr.find_virtuosonet(str(tmp_path / "nope"))
    monkeypatch.setenv("VIRTUOSONET_PATH", fake_checkout)
    assert tepr.find_virtuosonet() == fake_checkout
    monkeypatch.delenv("VIRTUOSONET_PATH")
    assert tepr.find_virtuosonet(workspace=str(tmp_path)) == fake_checkout
    with pytest.raises(RuntimeError, match="midi_syn='score'"):
        tepr.make_epr_generator(workspace=str(tmp_path / "absent"))
    xml = tmp_path / "chunk.xml"
    xml.write_text("<score/>")
    cwd = os.getcwd()
    out = tepr.make_epr_generator(fake_checkout)(str(xml), "Chopin")
    assert os.getcwd() == cwd and fake_checkout not in sys.path
    assert out == os.path.join(fake_checkout, "test_result",
                               "epr_by_isgn_z0.mid")
    with open(os.path.join(fake_checkout, "call_log.json")) as f:
        log = json.load(f)
    assert log == {"path_name": os.path.join("temp", "epr") + os.sep,
                   "composer": "Chopin", "cwd": fake_checkout}


def test_xml_to_midi_virtuosonet_equal_to_jax(fake_checkout, tmp_path):
    """midi_syn='epr' through each package's adapter on the fake checkout:
    the same composers drawn, the same MIDI after MIDIProcess."""
    from piano_a2s_tpu.data.epr import make_epr_generator as j_make
    kern = _kern_folder(tmp_path / "kern")
    roots = [str(tmp_path / n) for n in ("jax", "port")]
    for R, make, root in zip((jrender, trender),
                             (j_make, tepr.make_epr_generator), roots):
        R.split_datasets([0], root, kern_folder=kern, seed=2)
        R.xml_to_midi([0], root, midi_syn="epr", seed=2,
                      epr_generate=make(fake_checkout))
    names = _assert_trees_equal(*roots)
    assert sum("/midi/" in n for n in names) >= 4


# --- the command ---------------------------------------------------------------

SYN_YAML = """\
seed: 11
midi_syn: {midi_syn}
workspace: {root}
feature_folder: {root}/{name}_features
train_versions: 2
soundfont_folder: {root}/soundfonts
"""


def _syn_yaml(tmp_path, name, midi_syn="score", **extra):
    path = tmp_path / f"{name}.yaml"
    path.write_text(SYN_YAML.format(root=tmp_path, name=name,
                                    midi_syn=midi_syn)
                    + "".join(f"{k}: {v}\n" for k, v in extra.items()))
    return str(path)


@pytest.fixture()
def syn_inputs(fake_bin, tmp_path, monkeypatch):  # noqa: F811
    """MusicXML names for convert (a test, a valid and two train songs),
    the fake verovio's kern and MIDI, the fake FluidSynth's WAV."""
    for name in ("jax", "port"):
        xml = tmp_path / name / "xml"
        xml.mkdir(parents=True)
        for song in (TEST_SONG, VALID_SONG, "zz_one", "zz_two"):
            (xml / f"{song}.xml").write_text("<score/>")
    monkeypatch.setenv("FAKE_VEROVIO_HUM", os.path.join(
        FIXTURES, "mozart_k545_i_excerpt.krn"))
    midi = tmp_path / "fixture.mid"
    _write_test_midi(midi, n_beats=12)
    monkeypatch.setenv("FAKE_VEROVIO_MIDI", str(midi))
    wav = tmp_path / "fixture.wav"
    _sine_wav(wav, 1.0, rate=44100)
    monkeypatch.setenv("FAKE_FLUIDSYNTH_WAV", str(wav))
    return tmp_path


def _folders(tmp_path, name):
    return ["--kern-folder", str(tmp_path / name / "kern"),
            "--xml-folder", str(tmp_path / name / "xml")]


@pytest.mark.parametrize("midi_syn", ["score", "epr"])
def test_syn_command_equal_to_jax(syn_inputs, midi_syn, capsys):
    """All seven stages through each package's command (fake verovio and
    FluidSynth; midi_syn=epr on the native engine): the same kern folder
    and the same feature tree."""
    tmp = syn_inputs
    extra = ["epr_engine=native"] if midi_syn == "epr" else []
    for name, main in (("jax", jprepare.main), ("port", tprepare.main)):
        assert main(["syn", _syn_yaml(tmp, name, midi_syn), *extra,
                     *_folders(tmp, name)]) == 0
    out = capsys.readouterr().out
    assert ("EPR engine: native" in out) == (midi_syn == "epr")
    _assert_trees_equal(str(tmp / "jax" / "kern"), str(tmp / "port" / "kern"))
    names = _assert_trees_equal(str(tmp / "jax_features"),
                                str(tmp / "port_features"))
    specs = [n for n in names if "/spectrogram/" in n]
    assert len(specs) == sum("/wav/" in n for n in names) > 0
    assert f"wrote {len(specs)} spectrograms" in out
    assert any(n.startswith("test/0/wav/") for n in names)
    assert any(n.startswith("valid/0/wav/") for n in names)


def test_syn_command_stage_subset_and_overrides(syn_inputs, capsys):
    """key=value arguments are overrides, not stages; a subset runs only
    its stages; train_versions=0 stops before any."""
    tmp = syn_inputs
    yaml_path = _syn_yaml(tmp, "port")
    assert tprepare.main(["syn", yaml_path, "convert", "train_versions=0",
                          *_folders(tmp, "port")]) == 0
    assert "nothing to do" in capsys.readouterr().out
    assert not (tmp / "port" / "kern").exists()
    assert tprepare.main(["syn", yaml_path, "clean", "convert",
                          f"feature_folder={tmp}/other",
                          *_folders(tmp, "port")]) == 0
    out = capsys.readouterr().out
    assert "Converting MuseSyn" in out and "deleted 0 invalid clips" in out
    assert "Splitting" not in out and "Synthesizing" not in out
    assert len(os.listdir(tmp / "port" / "kern")) == 4
    assert not (tmp / "port_features").exists()


def test_syn_command_rejects_unknown_stage(syn_inputs, capsys):
    yaml_path = _syn_yaml(syn_inputs, "port")
    with pytest.raises(SystemExit) as e:
        tprepare.main(["syn", yaml_path, "spectrogram"])  # a typo
    assert e.value.code == 2
    assert "unknown stage" in capsys.readouterr().err
    assert not (syn_inputs / "port_features").exists()


@pytest.mark.parametrize("engine,error", [
    ("virtuosonet", RuntimeError), ("bogus", SystemExit)])
def test_syn_command_epr_fails_fast(syn_inputs, monkeypatch, engine, error):
    """midi_syn=epr with no engine to render it stops before the midi
    stage renders (and drops) any chunk: no virtuosoNet checkout when one
    is required, or an unknown engine."""
    tmp = syn_inputs
    monkeypatch.chdir(tmp)
    monkeypatch.delenv("VIRTUOSONET_PATH", raising=False)
    yaml_path = _syn_yaml(tmp, "port", "epr")
    with pytest.raises(error, match="virtuosoNet|auto.virtuosonet.native"):
        tprepare.main(["syn", yaml_path, "midi", f"epr_engine={engine}",
                       *_folders(tmp, "port")])
    assert not (tmp / "port_features").exists()


def test_asap_command_equal_to_jax(fake_bin, tmp_path, monkeypatch,  # noqa: F811
                                   capsys):
    _asap_checkout(tmp_path, monkeypatch)
    for name, main in (("jax", jprepare.main), ("port", tprepare.main)):
        path = tmp_path / f"{name}.yaml"
        path.write_text(ASAP_YAML.format(root=tmp_path, name=name))
        assert main(["asap", str(path)]) == 0
    assert capsys.readouterr().out.count("done; 1 unmatched") == 2
    names = _assert_trees_equal(str(tmp_path / "jax_features"),
                                str(tmp_path / "port_features"))
    assert "unmatched.txt" in names
    assert any(n.startswith("train/audio/") for n in names)
