"""The port's synthetic corpus (piano_a2s_tpu_torch/data/synth.py) against
the JAX package's on the CPU: for the same seed every file it writes is
byte-equal to the original's, and the port's loader and train step take
the corpus."""

import filecmp
import os

import numpy as np
import pytest
import torch

import piano_a2s_tpu.data.synth as jsynth
import piano_a2s_tpu_torch.data.synth as tsynth
from piano_a2s_tpu_torch.data.datasets import (DataLoader,
                                               SyntheticTrainDataset)
from piano_a2s_tpu_torch.models import (ModelConfig, ScoreTranscription,
                                        init_state_dict)
from piano_a2s_tpu_torch.ops.vqt import VQTConfig
from piano_a2s_tpu_torch.train import step as tstep

torch.set_num_threads(2)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _assert_same_files(a, b):
    names = _files(a)
    assert names and names == _files(b)
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n
    return names


def _both(tmp_path, call):
    roots = [str(tmp_path / name) for name in ("jax", "port")]
    outs = [call(mod, root) for mod, root in zip((jsynth, tsynth), roots)]
    assert outs[0] == outs[1]
    return _assert_same_files(*roots)


@pytest.mark.parametrize("chordal", [False, True], ids=["legacy", "chordal"])
@pytest.mark.parametrize("versions,style_mix", [(None, False),
                                                ([0, 1], True)],
                         ids=["one_version", "two_versions_style_mix"])
@pytest.mark.parametrize("frontend", ["none", "direct"])
def test_write_corpus_byte_equal_to_jax(tmp_path, chordal, versions,
                                        style_mix, frontend):
    names = _both(tmp_path, lambda mod, root: mod.write_corpus(
        root, "train", 2, seed=5, n_bars=2, frontend=frontend,
        versions=versions, style_mix=style_mix, chordal=chordal))
    subs = {n.split(os.sep)[2] for n in names}
    assert subs == {"target", "info", "audio"} | (
        {"spectrogram"} if frontend == "direct" else set())
    if versions:
        assert {n.split(os.sep)[1] for n in names} == {"0", "1"}
        assert any(os.path.basename(n)[0] == "S" for n in names)


def test_write_corpus_oracle_byte_equal_to_jax(tmp_path):
    names = _both(tmp_path, lambda mod, root: mod.write_corpus(
        root, "valid", 1, seed=2, n_bars=1, frontend="oracle",
        save_audio=False))
    assert [n.split(os.sep)[2] for n in names] == ["info", "spectrogram",
                                                  "target"]


def test_main_byte_equal_to_jax(tmp_path, capsys):
    def run(mod, root):
        mod.main([root, "--splits", "train:2,test:1", "--seed", "3",
                  "--bars", "2", "--frontend", "none", "--train-versions",
                  "2", "--style-mix", "--chordal"])
        return capsys.readouterr().out
    names = _both(tmp_path, run)
    assert {n.split(os.sep)[0] for n in names} == {"train", "test"}


def test_generators_equal_to_jax():
    for seed in range(3):
        ra, rb = (np.random.RandomState(seed) for _ in range(2))
        ta, aa = jsynth.make_song(ra, n_bars=2, upper_notes=(2, 4),
                                  lower_notes=(1, 3))
        tb, ab = tsynth.make_song(rb, n_bars=2, upper_notes=(2, 4),
                                  lower_notes=(1, 3))
        assert ta == tb
        np.testing.assert_array_equal(aa, ab)
        ta, bars_a = jsynth.draw_song_chordal(ra, n_bars=3)
        tb, bars_b = tsynth.draw_song_chordal(rb, n_bars=3)
        assert ta == tb
        np.testing.assert_array_equal(
            jsynth.synthesize_chordal_audio(bars_a, clip_seconds=2.0),
            tsynth.synthesize_chordal_audio(bars_b, clip_seconds=2.0))
        assert jsynth.version_timbre(ra) == tsynth.version_timbre(rb)
    # The audio is the decode of the target: rendering from the token ids
    # gives the bar texts' audio.
    target, audio = tsynth.make_song(np.random.RandomState(3), n_bars=2)
    np.testing.assert_allclose(tsynth.synthesize_target_audio(target), audio,
                               atol=1e-6)


def test_a_note_lands_on_its_vqt_bin():
    """The port's corpus is learnable: a rendered C4 peaks at its VQT bin
    in the port's host twin."""
    from piano_a2s_tpu_torch.ops.vqt import get_vqt_host
    out = np.zeros(2 * 16000, np.float64)
    tsynth.synthesize_bar("1c", 1.5, 16000, out, 0.25)
    spec = get_vqt_host(out.astype(np.float32), VQTConfig())
    assert abs(int(np.argmax(spec[spec.shape[0] // 2]))
               - round(60 * np.log2(261.63 / 27.5))) <= 1


def test_write_corpus_rejects_a_corpus_without_features(tmp_path):
    with pytest.raises(ValueError, match="no features"):
        tsynth.write_corpus(str(tmp_path), "train", 1, frontend="none",
                            save_audio=False)
    with pytest.raises(KeyError):
        tsynth.write_corpus(str(tmp_path), "train", 1, frontend="librosa")


def test_port_loader_and_train_step_take_the_corpus(tmp_path):
    """The port's SyntheticTrainDataset and DataLoader read a synth corpus
    in both feature modes, and one CPU train_step at a small width from
    its float32 audio (the log-VQT frontend in the step) is finite."""
    root = str(tmp_path)
    tsynth.write_corpus(root, "train", 3, seed=5, n_bars=2,
                        frontend="direct")
    batches = {}
    for features, shape in (("spectrogram", (3, 1, 1201, 480)),
                            ("audio", (3, 192000))):
        ds = SyntheticTrainDataset(root, "train", versions=[0],
                                   max_frame_num=1201, max_length=(64, 64),
                                   input_features=features,
                                   rng=np.random.RandomState(0))
        (batch,) = list(DataLoader(ds, 3, shuffle=False))
        assert batch[features].shape == shape
        assert batch[features].dtype == np.float32
        assert (batch["upper_lengths"] > 0).all()
        batches[features] = batch
    cfg = ModelConfig(conv_feature_size=8, hidden_size=8, max_bars=2,
                      max_length=(64, 64), note_emb_size=4,
                      staff_emb_size=4)
    model = ScoreTranscription(cfg)
    model.load_state_dict(init_state_dict(cfg, seed=0), strict=True)
    t_step, _ = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), from_audio=True,
        device="cpu")
    out = t_step(model, {k: v for k, v in batches["audio"].items()
                         if k not in ("names", "versions", "n_real")},
                 torch.Generator().manual_seed(0), 1.0)
    assert np.isfinite(float(out.loss))
