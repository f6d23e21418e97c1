"""The port's data-preparation path against the JAX package on the CPU:
the host VQT twins, both feature passes (WAV -> spectrogram/ and audio/
.npy) and their command, and the checkpoint import.

The feature passes run over WAV fixtures written with scipy into two copies
of one tree, one for each package; every file each writes must be
byte-equal to the other's."""

import filecmp
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

import piano_a2s_tpu.config as jconfig
import piano_a2s_tpu.data.asap as jasap
import piano_a2s_tpu.data.render as jrender
import piano_a2s_tpu.ops.vqt as jvqt
import piano_a2s_tpu.ops.vqt_oracle as joracle
import piano_a2s_tpu_torch.data.asap as tasap
import piano_a2s_tpu_torch.data.render as trender
import piano_a2s_tpu_torch.ops.vqt as tvqt
import piano_a2s_tpu_torch.ops.vqt_oracle as toracle
import piano_a2s_tpu_torch.train.harness as tharness
from piano_a2s_tpu.models import init_params, init_state
from piano_a2s_tpu.models.convert import to_torch_state_dict
from piano_a2s_tpu_torch.cli import finetune, import_checkpoint, prepare_data
from piano_a2s_tpu_torch.config import load_configs, load_experiment
from piano_a2s_tpu_torch.infer import load_transcriber
from piano_a2s_tpu_torch.models.convert import state_dict_from_jax
from piano_a2s_tpu_torch.train.checkpoint import Checkpointer
from piano_a2s_tpu_torch.train.synthetic import write_clips

torch.set_num_threads(2)

MAX_DURATION = 2.0


def _clip(seconds, sr, seed):
    """A chord of three damped partials plus a little noise, as int16."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = sum(np.sin(2 * np.pi * f * t) for f in 110.0 * 2 ** (
        rng.randint(0, 36, 3) / 12.0)) * np.exp(-t / 0.8) / 4
    y += 0.01 * rng.randn(len(t))
    return (np.clip(y, -1, 1) * 32767).astype(np.int16)


# (name, seconds, sample rate): the model rate, 44.1 kHz (resampled), and
# one clip over MAX_DURATION (skipped).
WAVS = (("a", 1.3, 16000), ("b", 1.1, 44100), ("long", 2.5, 16000))


def _write_wavs(folder, seed):
    os.makedirs(folder, exist_ok=True)
    for i, (name, seconds, sr) in enumerate(WAVS):
        wavfile.write(os.path.join(folder, f"{name}.wav"), sr,
                      _clip(seconds, sr, seed + i))


def _assert_trees_equal(a, b):
    names = []
    for dirpath, _, files in os.walk(a):
        for f in files:
            p = os.path.join(dirpath, f)
            q = os.path.join(b, os.path.relpath(p, a))
            assert os.path.exists(q), q
            assert filecmp.cmp(p, q, shallow=False), p
            names.append(os.path.relpath(p, a))
    n_b = sum(len(files) for _, _, files in os.walk(b))
    assert n_b == len(names)
    return sorted(names)


def _present(folder, sub, name):
    """A file the pass must leave alone: its bytes are not a VQT's."""
    os.makedirs(os.path.join(folder, sub), exist_ok=True)
    np.save(os.path.join(folder, sub, f"{name}.npy"), np.arange(3))


def _syn_tree(root):
    """{train,valid,test}/{0,1}/wav/, a clip of train/0 with both files
    present (skipped) and one of valid/1 with only its audio file."""
    for i, split in enumerate(("train", "valid", "test")):
        for v in (0, 1):
            _write_wavs(os.path.join(root, split, str(v), "wav"), 10 * i + v)
    _present(os.path.join(root, "train", "0"), "spectrogram", "a")
    _present(os.path.join(root, "train", "0"), "audio", "a")
    _present(os.path.join(root, "valid", "1"), "audio", "b")


def _copies(tmp_path, make):
    src = str(tmp_path / "src")
    make(src)
    out = [str(tmp_path / name) for name in ("jax", "port")]
    for d in out:
        shutil.copytree(src, d)
    return out


# --- the host VQT twins ------------------------------------------------------

def test_host_vqt_twins_bit_equal_to_jax():
    y = _clip(1.7, 16000, 3).astype(np.float32) / 32768.0
    cfg_j, cfg_t = jvqt.VQTConfig(), tvqt.VQTConfig()
    mag_j, mag_t = jvqt.vqt_host(y, cfg_j), tvqt.vqt_host(y, cfg_t)
    assert mag_t.dtype == np.float64 and mag_t.shape == (1 + len(y) // 160,
                                                         480)
    np.testing.assert_array_equal(mag_t, mag_j)
    spec = tvqt.get_vqt_host(y, cfg_t)
    assert spec.dtype == np.float32
    np.testing.assert_array_equal(spec, jvqt.get_vqt_host(y, cfg_j))
    np.testing.assert_array_equal(tvqt.log_compress_host(mag_t, 1e-4, 60.0),
                                  jvqt.log_compress_host(mag_j, 1e-4, 60.0))
    # The twin is the float64 form of the port's plain VQT.
    plain = tvqt.get_vqt(torch.from_numpy(y.astype(np.float64))[None],
                         tvqt.filters(cfg_t, "cpu", torch.float64), cfg_t)
    np.testing.assert_allclose(spec, plain[0].numpy(), atol=1e-6)


def test_librosa_oracle_bit_equal_to_jax():
    y = _clip(1.2, 16000, 4).astype(np.float32) / 32768.0
    np.testing.assert_array_equal(
        toracle.get_vqt_librosa_host(y, tvqt.VQTConfig()),
        joracle.get_vqt_librosa_host(y, jvqt.VQTConfig()))


# --- the feature passes ------------------------------------------------------

def test_syn_feature_pass_byte_equal_to_jax(tmp_path):
    j_root, t_root = _copies(tmp_path, _syn_tree)
    n_j = jrender.prepare_spectrograms([0, 1], j_root,
                                       max_duration=MAX_DURATION)
    n_t = trender.prepare_spectrograms([0, 1], t_root,
                                       max_duration=MAX_DURATION)
    assert n_t == n_j == 6 * 2 - 1  # "long" skipped, train/0/a present
    names = _assert_trees_equal(j_root, t_root)
    assert not any("long.npy" in n for n in names)
    # Present files are left alone; the missing half is written.
    assert np.load(os.path.join(t_root, "train/0/spectrogram/a.npy")).shape \
        == (3,)
    assert np.load(os.path.join(t_root, "valid/1/audio/b.npy")).shape == (3,)
    assert np.load(os.path.join(t_root, "valid/1/spectrogram/b.npy")).shape \
        == (1 + int(1.1 * 16000) // 160, 480)
    audio = np.load(os.path.join(t_root, "test/1/audio/b.npy"))
    assert audio.dtype == np.int16 and len(audio) == int(1.1 * 16000)
    # A second pass finds everything present.
    assert trender.prepare_spectrograms([0, 1], t_root,
                                        max_duration=MAX_DURATION) == 0


def _asap_tree(root):
    """{train,test}/target/*.pkl with their wav/ slices; one target
    without a WAV, one clip with both files present."""
    for i, split in enumerate(("train", "test")):
        folder = os.path.join(root, split)
        _write_wavs(os.path.join(folder, "wav"), 20 + i)
        os.makedirs(os.path.join(folder, "target"))
        for name in [w[0] for w in WAVS] + ["no_wav"]:
            with open(os.path.join(folder, "target", f"{name}.pkl"),
                      "wb") as f:
                pickle.dump([[0, "4/4", [1], [2]]], f)
    _present(os.path.join(root, "test"), "spectrogram", "b")
    _present(os.path.join(root, "test"), "audio", "b")


def test_asap_feature_pass_byte_equal_to_jax(tmp_path):
    j_root, t_root = _copies(tmp_path, _asap_tree)
    proc = jasap.ProcessASAP.__new__(jasap.ProcessASAP)
    proc.feature_folder, proc.sample_rate = j_root, 16000
    proc.max_duration = MAX_DURATION
    n_j = proc.prepare_spectrograms()
    n_t = tasap.prepare_spectrograms(t_root, 16000, MAX_DURATION)
    assert n_t == n_j == 3
    names = _assert_trees_equal(j_root, t_root)
    written = [n for n in names if not n.startswith(("train/wav", "test/wav",
                                                      "train/target",
                                                      "test/target"))]
    assert written == ["test/audio/a.npy", "test/audio/b.npy",
                       "test/spectrogram/a.npy", "test/spectrogram/b.npy",
                       "train/audio/a.npy", "train/audio/b.npy",
                       "train/spectrogram/a.npy", "train/spectrogram/b.npy"]


def _tiny_yaml(path, root, **extra):
    with open(path, "w") as f:
        f.write(CLI_YAML.format(root=root) + "".join(
            f"{k}: {v}\n" for k, v in extra.items()))
    return str(path)


def test_prepare_data_command_runs_the_feature_passes(tmp_path, capsys):
    j_root, t_root = _copies(tmp_path, _syn_tree)
    yaml_path = _tiny_yaml(tmp_path / "syn.yaml", str(tmp_path),
                           feature_folder=t_root, train_versions=2,
                           max_duration=2)
    assert prepare_data.main(["syn", yaml_path, "spectrograms"]) == 0
    assert "wrote 11 spectrograms" in capsys.readouterr().out
    jrender.prepare_spectrograms([0, 1], j_root, max_duration=2)
    _assert_trees_equal(j_root, t_root)

    a_root = str(tmp_path / "asap")
    _asap_tree(a_root)
    assert prepare_data.main(["asap", yaml_path, f"feature_folder={a_root}"
                              ]) == 0
    assert len(os.listdir(os.path.join(a_root, "train", "spectrogram"))) == 2


# --- the checkpoint import ---------------------------------------------------

CLI_YAML = """\
seed: 7
midi_syn: score
workspace: {root}
output_folder: {root}/<version>
pretrained_output_folder: {root}/pre
feature_folder: {root}/<corpus>
save_folder: <output_folder>/save
train_log: <output_folder>/train_log.txt
max_length: [8, 6]
max_bars: 2
max_duration: 1
frames_per_second: 23
bins_per_octave: 4
n_octaves: 4
number_of_epochs: 1
batch_size: 2
lr: 0.5
conv_feature_size: 16
hidden_size: 16
note_emb_size: 8
staff_emb_size: 8
train_versions: 1
input_features: audio
version: fin
corpus: asap
"""


@pytest.fixture
def reference_save(tmp_path):
    """A SpeechBrain-style save folder of two CKPT dirs holding model.ckpt
    files made from JAX weights with to_torch_state_dict (WER 31.5 and
    12.25: the second is the best); returns (folder, yaml, the best's
    weights as the port's state dict)."""
    yaml_path = _tiny_yaml(tmp_path / "tiny.yaml", str(tmp_path))
    jcfg = jconfig.load_experiment(yaml_path).model_config()
    tcfg = load_experiment(yaml_path).model_config()
    save = tmp_path / "reference_save"
    best = None
    for i, wer in enumerate((31.5, 12.25)):
        params = jax.tree.map(np.asarray,
                              init_params(jax.random.PRNGKey(i), jcfg))
        state = jax.tree.map(lambda x: np.asarray(x) + 0.1 * (i + 1),
                             init_state(jcfg))
        ckpt = save / f"CKPT+2024-01-0{i + 1}+00"
        os.makedirs(ckpt)
        sd = {f"0.{k}": v for k, v in
              to_torch_state_dict(params, state, jcfg).items()}
        torch.save(sd, ckpt / "model.ckpt")
        (ckpt / "CKPT.yaml").write_text(f"WER: {wer}\nloss: {i + 2.5}\n"
                                        f"end-of-epoch: True\n")
        best = state_dict_from_jax(params, state, tcfg)
    return str(save), yaml_path, best


def _only_checkpoint(save):
    (path,) = [os.path.join(save, d) for d in os.listdir(save)]
    return path


def test_import_checkpoint_writes_a_port_save_folder(reference_save,
                                                     tmp_path):
    src, yaml_path, ref = reference_save
    out = str(tmp_path / "imported")
    assert import_checkpoint.main([src, "--config", yaml_path,
                                   "--out", out]) == 0
    trees, host_state, meta = Checkpointer(out).load(_only_checkpoint(out))
    assert sorted(trees["model"]) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(trees["model"][k].numpy(),
                                      v.float().numpy(), err_msg=k)
    assert meta["WER"] == 12.25 and meta["loss"] == 3.5
    assert meta["imported_from"].endswith("CKPT+2024-01-02+00/model.ckpt")
    assert host_state == {"epoch": 0, "global_step": 0}
    opt = trees["optimizer"]
    assert opt["state"] == {}
    assert [(g["lr"], g["rho"], g["eps"]) for g in opt["param_groups"]] \
        == [(0.5, 0.95, 1e-8)]
    cfg, vqt_cfg, frames = load_configs(yaml_path)
    tr = load_transcriber(out, cfg, vqt_cfg, max_frame_num=frames,
                          device="cpu")
    assert all(torch.equal(tr.model.state_dict()[k], trees["model"][k])
               for k in ref)

    # One CKPT directory, and --wer over CKPT.yaml's.
    one = str(tmp_path / "one")
    assert import_checkpoint.main([os.path.join(src, "CKPT+2024-01-01+00"),
                                   "--config", yaml_path, "--out", one,
                                   "--wer", "7.5"]) == 0
    _, _, meta = Checkpointer(one).load(_only_checkpoint(one), ())
    assert meta["WER"] == 7.5 and meta["loss"] == 2.5


def test_finetune_warm_starts_from_an_imported_checkpoint(reference_save,
                                                          tmp_path,
                                                          monkeypatch):
    src, yaml_path, ref = reference_save
    root = str(tmp_path)
    # The import goes where finetune looks: <pretrained_output_folder>/save.
    assert import_checkpoint.main([src, "--config", yaml_path, "--out",
                                   os.path.join(root, "pre", "save")]) == 0
    kw = dict(samples=(2500, 3800), upper=(1, 7), lower=(1, 5), bars=2)
    for split in ("train", "test"):
        write_clips(os.path.join(root, "asap", split), 2, seed=9, **kw)
    seen = []
    restore = tharness.Trainer.restore

    def spy(trainer, path):
        meta = restore(trainer, path)
        seen.append((path, {k: v.clone() for k, v in
                            trainer.model.state_dict().items()},
                     trainer.optimizer.state_dict()))
        return meta

    monkeypatch.setattr(tharness.Trainer, "restore", spy)
    assert finetune.main([yaml_path, "--device", "cpu"]) == 0
    path, model, optimizer = seen[0]  # the warm start
    assert os.path.basename(path).startswith("CKPT+")
    for k, v in ref.items():
        np.testing.assert_array_equal(model[k].numpy(), v.float().numpy(),
                                      err_msg=k)
    assert optimizer["state"] == {}
    assert [g["lr"] for g in optimizer["param_groups"]] == [0.5]
    fin = os.path.join(root, "fin")
    assert "epoch: 1" in open(os.path.join(fin, "train_log.txt")).read()
    assert len(os.listdir(os.path.join(fin, "results", "test"))) == 2
