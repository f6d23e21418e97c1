"""The port's kern tokenizer and native kern tools against the JAX package
on the CPU.

``symbolic/humdrum.py`` runs on the four real-score excerpts of
tests/fixtures/kern and on the random scores of tests/test_humdrum.py,
and every transform must return what the JAX package's returns (``==`` on
strings). The native kern tools are held library against library and
Python twin against twin (never one against the other by accident), and
the port's library must be built from its own copy of the C++ source into
build/piano_a2s_tpu_torch/, never loaded from the JAX package."""

import glob
import json
import os
import pickle
import random
import subprocess
import sys
import warnings

import numpy as np
import pytest

import piano_a2s_tpu.symbolic.humdrum as JH
import piano_a2s_tpu.symbolic.native as jnative
import piano_a2s_tpu_torch.symbolic.humdrum as TH
import piano_a2s_tpu_torch.symbolic.native as tnative
from conftest import REPO_ROOT
from piano_a2s_tpu_torch.data.datasets import load_time_signatures
from piano_a2s_tpu_torch.data.render import split_single_score
from piano_a2s_tpu_torch.symbolic.vocab import LabelsMultiple
from test_humdrum import PITCH, _score, _spine_script_score

FIXTURES = sorted(glob.glob(os.path.join(REPO_ROOT, "tests", "fixtures",
                                         "kern", "*.krn")))
GOLDENS = os.path.join(REPO_ROOT, "tests", "goldens")


def _read(path):
    with open(path, encoding="iso-8859-1") as f:
        return f.read()


def _dump(k):
    return k if k is False or k is None else k.dump()


def _outcome(fn, *args):
    """fn(*args), or the name of what it raised: the reference's quirks
    crash on some inputs, and the copies must crash alike."""
    try:
        return fn(*args)
    except (IndexError, ValueError, KeyError, ZeroDivisionError) as e:
        return type(e).__name__


def _pipeline(H, text):
    """Every tokenizer transform the data preparation runs, on one kern
    text, as comparable values."""
    out = {}
    k = H.Kern(data=text)
    out["parse"] = (k.header, k.body, k.footer, k.first_line,
                    k.spines.dump())
    out["clean"] = k.clean()
    out["cleaned"] = k.dump()
    out["segments"] = H.count_measure_segments("\n".join(k.body))
    out["sequence"] = _outcome(k.tosequence)
    for size, stride in ((5, 2), (5, 5), (5, 1), (3, 1)):
        out[f"split{size}/{stride}"] = [
            c.dump() for c in H.Kern(data=k.dump()).split(size, stride)]
    sc = H.sort_chords(H.Kern(data=k.dump()))
    out["sort_chords"] = sc.dump()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["sort_voices"] = _dump(H.sort_voices(sc))
        pv = _outcome(H.process_voices, H.Kern(data=k.dump()))
        out["process_voices"] = pv if isinstance(pv, str) else _dump(pv)
        if not isinstance(pv, str) and pv is not False:
            out["target_sequence"] = H.sort_voices(
                H.sort_chords(pv))
            out["target_sequence"] = _dump(out["target_sequence"])
    out["dedupe"] = H.eliminate_duplicate_chords(
        H.Kern(data=k.dump())).dump()
    return out


@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p)[:-4] for p in FIXTURES])
def test_tokenizer_on_real_scores(path):
    text = _read(path)
    staves = [text] + [jnative.extract_spine(text, s) for s in (1, 2)]
    assert staves[1:] == [tnative.extract_spine(text, s) for s in (1, 2)]
    for stave in staves:
        assert _pipeline(TH, stave) == _pipeline(JH, stave)


def _fuzz_scores(kind):
    if kind == "single":
        rng = random.Random(0)
        return [_score(rng, n_measures=rng.randint(6, 12))
                for _ in range(40)]
    if kind == "no_splits":
        rng = random.Random(6)
        return [_score(rng, with_splits=False) for _ in range(30)]
    rng = random.Random(7)
    return [_spine_script_score(rng, n_spines=rng.choice([1, 2, 3]))
            for _ in range(60)]


@pytest.mark.parametrize("kind", ["single", "no_splits", "mixed_splits"])
def test_tokenizer_fuzz(kind):
    """tests/test_humdrum.py's random scores (spine splits and merges,
    decorations the cleaner strips, ties, chords with rests) through every
    transform of both packages."""
    for trial, text in enumerate(_fuzz_scores(kind)):
        assert _pipeline(TH, text) == _pipeline(JH, text), trial


def test_mixed_split_lines_constrained():
    """The mixed split scores again, in the constrained mode."""
    rng = random.Random(7)
    for trial in range(60):
        text = _spine_script_score(rng, n_spines=rng.choice([1, 2, 3]))
        got, want = (H.Kern(data=text, constrained=True) for H in (TH, JH))
        assert got.clean() == want.clean(), trial
        assert got.dump() == want.dump(), trial
        assert _outcome(got.tosequence) == _outcome(want.tosequence), trial
        assert [c.dump() for c in got.split(3, 2)] == \
            [c.dump() for c in want.split(3, 2)], trial


def test_small_helpers():
    for p in PITCH + ["ccc", "AAA", "bb-", "ff#"]:
        assert TH.kern_to_midi(p) == JH.kern_to_midi(p)
    body = ["4c", "4d\t4e", "4f\t4g", "2a", "!comment", "4b"]
    assert TH.add_split_token(list(body)) == JH.add_split_token(list(body))
    for voices in ((["4c", "4d", "2e"], ["2C", "null", "2G"]),
                   (["2c", "null"], ["4C", "4D"]),
                   (["4r", "null"], ["2C", "."]),
                   (["4r", "*"], ["null", "4r"])):
        assert TH.merge_voices(*voices) == JH.merge_voices(*voices)
    assert TH.BARLINE_RE.pattern == JH.BARLINE_RE.pattern
    assert TH.CLASSIC_TEMPOS == JH.CLASSIC_TEMPOS
    unpitched = "\n".join(["**kern", "*clefF4", "=1", "4r 4c", "4e 8r 4C",
                           "2g 2d", "=", "*-"]) + "\n"
    assert TH.sort_chords(TH.Kern(data=unpitched)).dump() == \
        JH.sort_chords(JH.Kern(data=unpitched)).dump()


def test_vocabulary_goldens():
    with open(os.path.join(GOLDENS, "tokenizer_encode.json")) as f:
        cases = json.load(f)
    labels = LabelsMultiple(extended=True)
    assert cases
    for case in cases:
        assert labels.encode(case["text"]) == case["tokens"]
        assert labels.decode(case["tokens"]) == case["decoded"]


def test_real_score_targets_match_goldens(tmp_path):
    """tests/test_real_scores.py's pin: the first test-split chunk of every
    excerpt, through the port's split_single_score."""
    with open(os.path.join(GOLDENS, "real_scores.json")) as f:
        golden = json.load(f)
    labels, ts_list = LabelsMultiple(extended=True), load_time_signatures()
    assert sorted(golden) == [os.path.basename(p)[:-4] for p in FIXTURES]
    for path in FIXTURES:
        name = os.path.basename(path)[:-4]
        assert split_single_score(path, str(tmp_path), labels, ts_list,
                                  split="test", version=0,
                                  rng=np.random.RandomState(0)) >= 1
        with open(tmp_path / "test" / "0" / "target" / f"{name}.0.pkl",
                  "rb") as f:
            target = pickle.load(f)
        got = [[int(m[0]), str(m[1]), list(map(int, m[2])),
                list(map(int, m[3]))] for m in target]
        assert got == golden[name], name


# --- the native kern tools ---------------------------------------------------

def test_cpp_source_is_a_copy():
    with open(os.path.join(REPO_ROOT, "native", "kern_tools.cpp"),
              "rb") as f:
        jax_src = f.read()
    with open(tnative.SOURCE, "rb") as f:
        assert f.read() == jax_src
    assert tnative.SOURCE == os.path.join(
        REPO_ROOT, "piano_a2s_tpu_torch", "native", "kern_tools.cpp")


def test_library_built_into_the_port_build_folder():
    assert tnative.native_available()
    path = tnative._load_lib()._name
    assert path == tnative.library_path()
    assert os.path.dirname(path) == os.path.join(REPO_ROOT, "build",
                                                 "piano_a2s_tpu_torch")
    assert os.path.basename(path).startswith("libkern_tools_")


def test_port_never_opens_the_jax_library():
    """In a fresh process the port's tools run on its own library: the
    process maps it, and never the JAX package's libkern_tools.so."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from piano_a2s_tpu_torch.symbolic import native\n"
        "assert native.native_available()\n"
        "native.extract_spine('**kern\\n4c\\n*-\\n', 1)\n"
        "native.tiefix_kern('**kern\\n[4c\\n*-\\n')\n"
        "native.transpose_kern('**kern\\n4c\\n*-\\n', 'M2')\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(native.library_path() in maps)\n"
        "print('libkern_tools.so' in maps)\n"
        "print(any(m.startswith('piano_a2s_tpu.') or m == 'piano_a2s_tpu'"
        " for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code, REPO_ROOT],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False", "False"]


def test_failed_build_says_why(tmp_path, monkeypatch):
    """A source that does not compile: the loader warns with the
    compiler's error and the Python twins answer."""
    bad = tmp_path / "kern_tools.cpp"
    bad.write_text("this is not C++ at all;\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    monkeypatch.delenv("KERN_TOOLS_NO_BUILD", raising=False)
    with pytest.warns(RuntimeWarning, match="(?s)g\\+\\+ failed.*error"):
        assert not tnative.native_available()
    assert not tnative.native_available()  # warned once, not rebuilt
    text = "**kern\n[4c\n4d\n*-\n"
    assert tnative.tiefix_kern(text) == tnative._py_tiefix(text)


def test_no_build_env_leaves_the_twins(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("KERN_TOOLS_NO_BUILD", "1")
    assert not tnative.native_available()
    assert tnative.extract_spine("**kern\t**kern\n4c\t4d\n*-\t*-\n", 2) == \
        "**kern\n4d\n*-\n"
    assert not os.path.exists(tmp_path / "build")


def _fuzz_kern(rng):
    """tests/test_native_tools.py's fuzz case generator."""
    durs = ["1", "2", "4", "8", "16"]
    pitches = ["C", "c", "cc", "B-", "f#", "AA", "d", "e-", "g", "r"]
    lines = ["**kern\t**kern", "*k[f#c#]\t*k[f#c#]", "*D:\t*D:"]
    for m in range(1, 4):
        lines.append(f"={m}\t={m}")
        for _ in range(rng.randint(1, 4)):
            def note():
                n = rng.choice(durs) + rng.choice(pitches)
                r = rng.random()
                if r < 0.2:
                    n = "[" + n
                elif r < 0.4:
                    n += rng.choice(["]", "_"])
                return n
            cols = [" ".join(note() for _ in range(rng.randint(1, 2)))
                    for _ in range(2)]
            lines.append("\t".join(cols))
    lines.append("*-\t*-")
    return "\n".join(lines) + "\n"


INTERVALS = ["m2", "M2", "m3", "M3", "-m2", "-M2", "-m3", "-M3", "0"]


def _tool_calls(text, iv):
    """(native symbol, its ctypes args, twin name, twin args) of each
    tool."""
    enc = text.encode("iso-8859-1")
    return [("kern_transpose", (enc, iv.encode()), "_py_transpose",
             (text, iv)),
            ("kern_tiefix", (enc,), "_py_tiefix", (text,)),
            ("kern_extract_spine", (enc, 1), "_py_extract_spine", (text, 1)),
            ("kern_extract_spine", (enc, 2), "_py_extract_spine", (text, 2))]


@pytest.mark.parametrize("impl", ["library", "twin", "public"])
def test_native_tools_fuzz(impl):
    """tests/test_native_tools.py's 120 fuzz cases: the port's library
    against the JAX package's library, each twin against its JAX twin, and
    the public functions (library-backed in both) against each other and
    against the port's twins."""
    assert tnative.native_available() and jnative.native_available()
    rng = random.Random(0)
    for trial in range(120):
        text = _fuzz_kern(rng)
        iv = rng.choice(INTERVALS)
        for sym, c_args, twin, py_args in _tool_calls(text, iv):
            if impl == "library":
                got = tnative._call_native(sym, *c_args)
                assert got is not None
                assert got == jnative._call_native(sym, *c_args), \
                    (trial, sym)
            elif impl == "twin":
                assert getattr(tnative, twin)(*py_args) == \
                    getattr(jnative, twin)(*py_args), (trial, twin)
        if impl == "public":
            for fn, args in (("transpose_kern", (text, iv)),
                             ("tiefix_kern", (text,)),
                             ("extract_spine", (text, 1)),
                             ("extract_spine", (text, 2))):
                got = getattr(tnative, fn)(*args)
                assert got == getattr(jnative, fn)(*args), (trial, fn)
            assert tnative.transpose_kern(text, iv) == \
                tnative._py_transpose(text, iv)
            assert tnative.tiefix_kern(text) == tnative._py_tiefix(text)


@pytest.mark.parametrize("text,iv", [
    ("**kern\n*k[f#]\n*G:\n4c 4e\n8B-\n4r\n*-\n", "M2"),
    ("**kern\n*k[]\n*C:\n4c\n4ee\n*-\n", "-m3"),
    ("**kern\n4b\n*-\n", "m2"),
    ("**kern\n*B:\n4B\n*-\n", "M2"),
    ("**kern\n*c:\n4c\n*-\n", "-m2"),
    ("**kern\n*k[b-e-]\n4B-\n4e-\n4ff\n*-\n", "M2"),
    ("**kern\n[4c\n4c]\n[4d\n=\n4e_\n*-\n", "0"),
    ("**kern\n[4c\n4c_\n*-\n", "0"),
    ("**kern\t**kern\n=1\t=1\n*^\t*\n4c\t4d\t4e\n*v\t*v\t*\n2f\t2g\n"
     "*-\t*-\n", "m3"),
], ids=["G-to-A", "down-m3", "octave", "major-case", "minor-case",
        "flats", "dangling", "continue", "split"])
def test_native_tools_cases(text, iv):
    """tests/test_native_tools.py's and test_symbolic_regressions.py's
    cases, both implementations of each package."""
    for fn, twin, args in (("transpose_kern", "_py_transpose", (text, iv)),
                           ("tiefix_kern", "_py_tiefix", (text,)),
                           ("extract_spine", "_py_extract_spine",
                            (text, 1))):
        want = getattr(jnative, fn)(*args)
        assert getattr(tnative, fn)(*args) == want
        assert getattr(tnative, twin)(*args) == getattr(jnative, twin)(*args)
    assert tnative.parse_interval(iv) == jnative.parse_interval(iv)
    with pytest.raises(ValueError):
        tnative.extract_spine("**kern\t**kern\n*x\t*x\n*-\t*-\n", 1)
