"""The port's training harness against the JAX package's on the CPU, at
the tiny width of tests/test_harness_e2e.py: the Trainer over two epochs,
length bucketing, checkpoints, resume and the finetune warm start, the
pretrain and finetune commands, and the options the port refuses.

The Trainer parity run injects the JAX Trainer's initial weights into the
port's (``state_dict_from_jax``), patches both packages' ``dropout`` to the
identity and sets teacher forcing to 1.0 without decay (the masks and coins
come from different generators). Both train in float32, so the losses and
parameters are held at float32 tolerances; the predictions, WER, F1 and
learning rates must be equal."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

import piano_a2s_tpu.config as jconfig
import piano_a2s_tpu.data.datasets as jdata
import piano_a2s_tpu.ops.layers as jL
import piano_a2s_tpu.train.harness as jharness
import piano_a2s_tpu_torch.cli.pretrain as tpretrain
import piano_a2s_tpu_torch.config as tconfig
import piano_a2s_tpu_torch.data.datasets as tdata
import piano_a2s_tpu_torch.ops.layers as tL
import piano_a2s_tpu_torch.train.harness as tharness
from conftest import REPO_ROOT
from piano_a2s_tpu.models import forward as j_forward
from piano_a2s_tpu.train.checkpoint import Checkpointer as JCheckpointer
from piano_a2s_tpu.train.losses import transcription_loss_fused
from piano_a2s_tpu_torch.infer import load_transcriber
from piano_a2s_tpu_torch.models.convert import state_dict_from_jax
from piano_a2s_tpu_torch.train.checkpoint import Checkpointer
from piano_a2s_tpu_torch.train.synthetic import write_clips
from test_harness_e2e import _make_fixture
from test_torch_train import (CFG, _assert_grads, _batch, _port_model,
                              _port_loss_and_grads, _weights)
from test_torch_train import no_dropout, x64  # noqa: F401 (fixtures)

torch.set_num_threads(2)

TINY = dict(seed=7, max_length=(8, 6), max_bars=2, max_duration=1,
            frames_per_second=23, bins_per_octave=4, n_octaves=4,
            number_of_epochs=2, batch_size=2, conv_feature_size=16,
            hidden_size=16, note_emb_size=8, staff_emb_size=8,
            teacher_forcing_ratio=1.0, teacher_forcing_decay=1.0)
# Both Trainers run in float32 (eps 1.2e-7), each summing in its own
# order. Observed after two epochs: the losses within 9e-8 relative, the
# weights within 2.4e-7; the bounds leave a margin of about 10x.
RTOL_LOSS = 1e-6
ATOL_WEIGHTS = 2e-6
# Bucketed against unbucketed, both float64: the same products; only sums
# over the cut-off <pad> positions (exact zeros) may associate differently.
ATOL_BUCKET = 1e-12
ATOL_JAX = 1e-8  # port against JAX in float64, as tests/test_torch_train.py


def _features(root):
    """The spectrogram corpus: 5 train clips and 3 valid clips (a padded
    final batch of 2 each), 2 test clips."""
    features = os.path.join(root, "features")
    _make_fixture(features, "train", 0, n_songs=5)
    _make_fixture(features, "valid", 0, n_songs=3, seed=1)
    _make_fixture(features, "test", 0, n_songs=2, seed=2)
    return features


def _exp(mod, root, features, name, **extras):
    out = os.path.join(root, name)
    exp = mod.ExperimentConfig(
        workspace=root, output_folder=out, feature_folder=features,
        save_folder=os.path.join(out, "save"),
        train_log=os.path.join(out, "train_log.txt"), **TINY)
    exp.extras.update(extras)
    return exp


def _loaders(mod, exp):
    kw = dict(max_frame_num=exp.max_frame_num, max_length=exp.max_length)
    train = mod.SyntheticTrainDataset(exp.feature_folder, "train",
                                      versions=[0],
                                      rng=np.random.RandomState(0), **kw)
    valid = mod.SyntheticTestDataset(exp.feature_folder, "valid",
                                     versions=[0], **kw)
    test = mod.SyntheticTestDataset(exp.feature_folder, "test",
                                    versions=[0], **kw)
    return (mod.DataLoader(train, exp.batch_size, shuffle=True, seed=0),
            mod.DataLoader(valid, exp.batch_size),
            mod.DataLoader(test, exp.batch_size))


def _run(trainer, mod, exp):
    """Fit and evaluate; returns the logged stats of every call and the
    result records, by split and clip."""
    logged = []
    log_stats = trainer.logger.log_stats

    def record(stats_meta, **stages):
        logged.append(dict(stages, meta=stats_meta))
        return log_stats(stats_meta, **stages)

    trainer.logger.log_stats = record
    train, valid, test = _loaders(mod, exp)
    trainer.fit(train, valid)
    trainer.evaluate(test)
    results = {}
    for split in ("valid", "test"):
        folder = os.path.join(exp.output_folder, "results", split)
        for f in sorted(os.listdir(folder)):
            with open(os.path.join(folder, f)) as fh:
                results[(split, f)] = json.load(fh)
    return logged, results


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer's run, and the port Trainer's on its initial
    weights, with dropout off in both."""
    root = str(tmp_path_factory.mktemp("trainer"))
    features = _features(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jL, "dropout", lambda key, x, rate, train: x)
        mp.setattr(tL, "dropout", lambda x, rate, train, generator=None: x)
        exp_j = _exp(jconfig, root, features, "jax", bucket_tokens=4)
        jtrainer = jharness.Trainer(exp_j)
        exp_t = _exp(tconfig, root, features, "port", bucket_tokens=4)
        init = state_dict_from_jax(jax.tree.map(np.asarray, jtrainer.params),
                                   jax.tree.map(np.asarray, jtrainer.state),
                                   exp_t.model_config())
        ttrainer = tharness.Trainer(exp_t, device="cpu", state_dict=init)
        runs = {"jax": _run(jtrainer, jdata, exp_j),
                "port": _run(ttrainer, tdata, exp_t)}
    final = state_dict_from_jax(jax.tree.map(np.asarray, jtrainer.params),
                                jax.tree.map(np.asarray, jtrainer.state),
                                exp_t.model_config())
    return runs, final, ttrainer, jtrainer.scheduler.state_dict()


def test_trainer_matches_jax_over_two_epochs(jax_run):
    runs, final, ttrainer, j_scheduler = jax_run
    (log_t, res_t), (log_j, res_j) = runs["port"], runs["jax"]
    assert [e["meta"].get("epoch", "test") for e in log_t] == [1, 2, "test"]
    assert len(log_t) == len(log_j)
    for got, ref in zip(log_t, log_j):
        assert sorted(got) == sorted(ref)
        if "lr" in ref["meta"]:
            assert got["meta"]["lr"] == ref["meta"]["lr"]
        for stage in ("train_stats", "valid_stats", "test_stats"):
            if stage not in ref:
                continue
            assert list(got[stage]) == list(ref[stage])
            for k, v in ref[stage].items():
                if "loss" in k:
                    np.testing.assert_allclose(got[stage][k], v,
                                               rtol=RTOL_LOSS, err_msg=k)
                else:  # WER, F1, teacher forcing
                    assert got[stage][k] == v, (stage, k)
    assert ttrainer.scheduler.state_dict() == j_scheduler
    assert sorted(res_t) == sorted(res_j) and len(res_t) == 5
    for key, rec in res_j.items():
        assert res_t[key]["pred"] == rec["pred"], key
        assert sorted(res_t[key]) == sorted(rec)
    # the evaluated (best) weights and BatchNorm statistics
    sd = ttrainer.model.state_dict()
    assert sorted(sd) == sorted(final)
    for k, v in final.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                   atol=ATOL_WEIGHTS, rtol=0, err_msg=k)


def test_trainer_keeps_one_checkpoint_of_four_files(jax_run):
    ttrainer = jax_run[2]
    exp = ttrainer.exp
    ckpts = [d for d in os.listdir(exp.save_folder) if d.startswith("CKPT")]
    assert len(ckpts) == 1
    best = os.path.join(exp.save_folder, ckpts[0])
    assert sorted(os.listdir(best)) == ["host_state.json", "meta.json",
                                        "model.pt", "optimizer.pt"]
    with open(os.path.join(best, "host_state.json")) as f:
        host = json.load(f)
    assert host["epoch"] in (1, 2) and host["global_step"] in (3, 6)
    opt = torch.load(os.path.join(best, "optimizer.pt"), weights_only=True)
    steps = {float(s["step"]) for s in opt["state"].values()}
    assert steps == {float(host["global_step"])}
    log = open(exp.train_log).read()
    assert "epoch: 2" in log and "stage: test" in log


# --- length bucketing --------------------------------------------------------

def _short_batch(b=2, seed=3):
    """test_torch_train's batch with every staff cut to 1-3 tokens, EOS
    after them and <pad> to the caps (10, 7)."""
    batch = _batch(b=b, seed=seed)
    rng = np.random.RandomState(seed)
    for staff in ("upper", "lower"):
        tok = batch[staff]
        for i in range(b):
            for m in range(CFG.max_bars):
                n = rng.randint(1, 4)
                tok[i, m, n:] = CFG.pad
                tok[i, m, n] = CFG.eos
                batch[f"{staff}_lengths"][i, m] = n
    return batch


def _jax_bucketed_loss_and_grads(params, state, batch, cfg):
    import jax.numpy as jnp
    gt = tuple(jnp.asarray(batch[k]) for k in (
        "time_sig", "key", "upper", "upper_lengths", "lower",
        "lower_lengths"))
    tbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        outs, _ = j_forward(p, state, tbatch["spectrogram"],
                            jax.random.PRNGKey(0), cfg=cfg, train=True,
                            ground_truth=gt, tf_ratio=1.0, emit_full=False)
        return transcription_loss_fused(outs, tbatch, cfg.pad)

    (loss, comps), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), comps, grads


def test_bucketed_step_equals_full_and_jax(x64, no_dropout, tmp_path):
    """The Trainer cuts a batch of short targets to (4, 4); the train
    forward's loss and gradients at that width equal the full width's, and
    the JAX package's bucketed step."""
    import dataclasses
    exp = tconfig.ExperimentConfig(
        workspace=str(tmp_path), output_folder=str(tmp_path / "o"),
        save_folder=str(tmp_path / "o" / "save"),
        train_log=str(tmp_path / "o" / "log.txt"), max_length=(10, 7),
        max_bars=2, bins_per_octave=6, n_octaves=4, conv_feature_size=32,
        hidden_size=24, note_emb_size=8, staff_emb_size=8)
    exp.extras["bucket_tokens"] = 4
    trainer = tharness.Trainer(exp, device="cpu")
    assert dataclasses.asdict(trainer.cfg) == dataclasses.asdict(CFG)
    batch = _short_batch()
    cut = trainer._bucketed(batch)
    assert cut["upper"].shape[-1] == 4 and cut["lower"].shape[-1] == 4
    long = _batch(b=2, seed=8)
    assert trainer._bucketed(long) is long   # its targets need the caps

    params, state = _weights()
    results = []
    for b in (batch, cut):
        model = _port_model(params, state)
        loss, comps, _ = _port_loss_and_grads(model, b, True, 1.0)
        results.append((loss, comps, {n: p.grad for n, p in
                                      model.named_parameters()}))
    (loss_f, comps_f, grads_f), (loss_b, comps_b, grads_b) = results
    assert np.isfinite(loss_f)
    np.testing.assert_allclose(loss_b, loss_f, atol=ATOL_BUCKET, rtol=0)
    for k in comps_f:
        np.testing.assert_allclose(float(comps_b[k]), float(comps_f[k]),
                                   atol=ATOL_BUCKET, rtol=0, err_msg=k)
    for n in grads_f:
        np.testing.assert_allclose(grads_b[n].numpy(), grads_f[n].numpy(),
                                   atol=ATOL_BUCKET, rtol=0, err_msg=n)

    cfg_b = dataclasses.replace(CFG, max_length=(4, 4))
    loss_j, comps_j, grads_j = _jax_bucketed_loss_and_grads(
        params, state, cut, cfg_b)
    np.testing.assert_allclose(loss_b, loss_j, atol=ATOL_JAX, rtol=0)
    for k in comps_j:
        np.testing.assert_allclose(float(comps_b[k]), float(comps_j[k]),
                                   atol=ATOL_JAX, rtol=0, err_msg=k)
    model = _port_model(params, state)
    _port_loss_and_grads(model, cut, True, 1.0)
    _assert_grads(model, grads_j, atol=ATOL_JAX)


def test_targets_wider_than_the_caps_raise():
    model = _port_model(*_weights())
    batch = _batch(b=1)
    batch["upper"] = np.pad(batch["upper"], ((0, 0), (0, 0), (0, 2)),
                            constant_values=CFG.pad)
    with pytest.raises(ValueError, match="exceed max_length"):
        _port_loss_and_grads(model, batch, False, 1.0)


# --- checkpoints -------------------------------------------------------------

def _trees(value):
    return {"model": {"w": torch.full((3,), float(value))},
            "optimizer": {"state": {}, "param_groups": []}}


def test_partial_checkpoint_ignored_and_swept(tmp_path):
    """A CKPT dir without meta.json (the debris of a save cut off before
    its commit marker) is invisible to best/latest/resume and swept by the
    next save_and_keep_only, even one that skips its save."""
    ckptr = Checkpointer(str(tmp_path / "save"))
    good = ckptr.save_and_keep_only(_trees(1), {"WER": 5.0}, {"epoch": 1})
    partial = str(tmp_path / "save" / "CKPT+9999+partial")
    os.makedirs(partial)
    torch.save({"w": torch.zeros(3)}, os.path.join(partial, "model.pt"))
    assert ckptr.latest_path() == good and ckptr.best_path() == good
    worse = ckptr.save_and_keep_only(_trees(9), {"WER": 7.0}, {"epoch": 2})
    assert worse == good and ckptr._ckpt_dirs() == [good]
    assert not os.path.exists(partial)
    os.makedirs(partial)
    ckptr.save_and_keep_only(_trees(2), {"WER": 4.0}, {"epoch": 2})
    assert not os.path.exists(partial)
    trees, host_state, meta = ckptr.load(ckptr.best_path())
    torch.testing.assert_close(trees["model"]["w"], torch.full((3,), 2.0))
    assert host_state["epoch"] == 2 and meta["WER"] == 4.0
    assert not os.path.exists(os.path.join(ckptr.best_path(),
                                           ".meta.json.tmp"))
    # the same skip/keep decisions as the JAX package's Checkpointer
    jck = JCheckpointer(str(tmp_path / "jax"))
    for wer in (5.0, 7.0, 4.0):
        jck.save_and_keep_only({"params": {"w": np.zeros(3, np.float32)}},
                               {"WER": wer})
    assert len(jck._ckpt_dirs()) == len(ckptr._ckpt_dirs()) == 1


def test_checkpoint_tag_collision_same_second(tmp_path):
    ck = Checkpointer(str(tmp_path / "save"))
    p1 = ck.save_and_keep_only(_trees(0), {"WER": 2.0})
    p2 = ck.save_and_keep_only(_trees(0), {"WER": 1.0})
    p3 = ck.save_and_keep_only(_trees(0), {"WER": 0.5})
    assert len({p1, p2, p3}) == 3
    assert os.path.isdir(p3) and ck._ckpt_dirs() == [p3]


def _state_equal(a, b):
    """Bitwise equality of two (optimizer or model) state dicts."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_state_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_state_equal, a, b))
    return a == b


def test_resume_restores_adadelta_and_warm_start_is_fresh(tmp_path):
    """Resume restores the whole Adadelta state bitwise and trains on to
    epoch 3; a warm start imported from the save folder restores the
    weights with a fresh Adadelta at exp.lr."""
    root = str(tmp_path)
    features = _features(root)
    exp = _exp(tconfig, root, features, "pre", bucket_tokens=4)
    exp.number_of_epochs = 1
    exp.lr = 0.5
    train, valid, _ = _loaders(tdata, exp)
    trainer = tharness.Trainer(exp, device="cpu")
    trainer.fit(train, valid)
    opt = trainer.optimizer.state_dict()
    assert opt["state"] and all(float(s["step"]) == 3
                                for s in opt["state"].values())

    resumed = tharness.Trainer(exp, device="cpu")
    assert resumed.try_resume() and resumed.start_epoch == 2
    assert _state_equal(resumed.optimizer.state_dict(), opt)
    assert _state_equal(resumed.model.state_dict(),
                        trainer.model.state_dict())
    assert resumed.scheduler.state_dict() == trainer.scheduler.state_dict()
    resumed.fit(train, valid, epochs=3)
    log = open(exp.train_log).read()
    assert "epoch: 2" in log and "epoch: 3" in log

    warm_exp = _exp(tconfig, root, features, "fin")
    warm_exp.lr = 0.25
    Checkpointer(warm_exp.save_folder).import_from(
        exp.save_folder, reset_meta={"WER": 100},
        reset_host_state={"epoch": 0, "global_step": 0})
    warm = tharness.Trainer(warm_exp, device="cpu")
    assert warm.try_resume() and warm.start_epoch == 1
    assert warm.global_step == 0
    state = warm.optimizer.state_dict()
    assert state["state"] == {}
    assert [g["lr"] for g in state["param_groups"]] == [0.25]
    assert _state_equal(state, tharness.Trainer(
        warm_exp, device="cpu").optimizer.state_dict())
    best = Checkpointer(exp.save_folder).best_path()
    saved, _, _ = Checkpointer(exp.save_folder).load(best)
    assert _state_equal(warm.model.state_dict(), saved["model"])


# --- the commands, end to end ------------------------------------------------

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
number_of_epochs: 2
batch_size: 2
conv_feature_size: 16
hidden_size: 16
note_emb_size: 8
staff_emb_size: 8
train_versions: 1
input_features: audio
"""


def _cli(module, yaml_path, *args):
    return subprocess.run(
        [sys.executable, "-m", f"piano_a2s_tpu_torch.cli.{module}",
         yaml_path, "--device", "cpu", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)


def test_pretrain_then_finetune_commands_from_audio(tmp_path):
    """python -m ...cli.pretrain then ...cli.finetune on a tiny corpus of
    int16 clips (the log-VQT inside every step); then load_transcriber on
    the finetune save folder transcribes a clip."""
    root = str(tmp_path)
    kw = dict(samples=(2500, 3800), upper=(1, 7), lower=(1, 5), bars=2)
    for split, n in (("train", 4), ("valid", 2), ("test", 2)):
        write_clips(os.path.join(root, "synth", split, "0"), n,
                    seed=len(split), **kw)
    for split in ("train", "test"):
        write_clips(os.path.join(root, "asap", split), 2, seed=9, **kw)
    yaml_path = str(tmp_path / "tiny.yaml")
    with open(yaml_path, "w") as f:
        f.write(CLI_YAML.format(root=root))

    r = _cli("pretrain", yaml_path, "version=pre", "corpus=synth",
             "number_of_epochs=1", "profile_trace_steps=1", "--profile")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "WER" in r.stdout
    pre = os.path.join(root, "pre")
    log = open(os.path.join(pre, "train_log.txt")).read()
    assert "epoch: 1" in log and "epoch: 2" not in log and "step_ms" in log
    assert os.path.exists(os.path.join(pre, "hyperparams.yaml"))
    times = json.load(open(os.path.join(pre, "profile", "step_times.json")))
    assert times["train_step"]["count"] == 2
    with open(os.path.join(pre, "profile", "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    assert len(os.listdir(os.path.join(pre, "results", "valid"))) == 2
    assert len(os.listdir(os.path.join(pre, "results", "test"))) == 2

    r = _cli("finetune", yaml_path, "version=fin", "corpus=asap",
             "number_of_epochs=1", "teacher_forcing_decay=1.0")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "WARNING: no pretrained" not in r.stdout
    fin = os.path.join(root, "fin")
    assert "epoch: 1" in open(os.path.join(fin, "train_log.txt")).read()
    results = os.listdir(os.path.join(fin, "results", "test"))
    assert len(results) == 2 and all(x.startswith("asap~") for x in results)
    with open(os.path.join(fin, "results", "test", results[0])) as f:
        rec = json.load(f)
    assert rec["composer"] == "synthetic"
    clip_name = results[0][len("asap~"):-len(".json")]
    assert rec["target_path"] == os.path.join(
        root, "asap", "test", "target", f"{clip_name}.pkl")
    save = os.path.join(fin, "save")
    ckpts = [d for d in os.listdir(save) if d.startswith("CKPT")]
    assert len(ckpts) == 1

    cfg, vqt_cfg, frames = tconfig.load_configs(
        os.path.join(fin, "hyperparams.yaml"))
    tr = load_transcriber(save, cfg, vqt_cfg, max_frame_num=frames,
                          device="cpu")
    saved = torch.load(os.path.join(save, ckpts[0], "model.pt"),
                       weights_only=True)
    assert _state_equal(tr.model.state_dict(), saved)
    again = load_transcriber(os.path.join(save, ckpts[0]), cfg, vqt_cfg,
                             max_frame_num=frames, device="cpu")
    clip = np.load(os.path.join(root, "asap", "test", "audio", "clip0.npy"))
    bars = tr.transcribe(clip)
    assert len(bars) == 2 and bars == again.transcribe(clip)
    with pytest.raises(ValueError, match="export_reference_checkpoint"):
        load_transcriber(os.path.join(root, "synth"), cfg, vqt_cfg,
                         device="cpu")


# --- options -----------------------------------------------------------------

@pytest.mark.parametrize("extras,match", [
    ({"train_dtype": "int8"}, "train_dtype"),
    ({"eval_decode_chunk": "sixteen"}, "invalid literal"),
    ({"input_features": "mel"}, "input_features"),
    ({"upload_dtype": "int8"}, "upload_dtype"),
    ({"accum_steps": 3}, "must divide"),
    ({"guided_attention": 1.0, "guided_attention_sigma": 0.0}, "sigma"),
    ({"guided_attention_map": "bars"}, "auto|events|tokens")])
def test_unported_and_bad_options_raise(tmp_path, extras, match):
    exp = _exp(tconfig, str(tmp_path), str(tmp_path), "o", **extras)
    with pytest.raises(ValueError, match=match):
        tharness.Trainer(exp, device="cpu")
    jexp = _exp(jconfig, str(tmp_path), str(tmp_path), "j", **extras)
    with pytest.raises(ValueError, match=match):
        jharness.Trainer(jexp)


def test_data_parallel_and_missing_card_raise(tmp_path, monkeypatch, capsys):
    exp = _exp(tconfig, str(tmp_path), str(tmp_path), "o")
    with pytest.raises(ValueError, match="data-parallel"):
        tharness.Trainer(exp, device="cpu", use_mesh=True)
    for flag in ("--data-parallel", "--multihost"):
        with pytest.raises(SystemExit):
            tpretrain.main(["x.yaml", flag, "--device", "cpu"])
        assert "runs under torchrun" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tharness.Trainer(exp)
    yaml_path = str(tmp_path / "c.yaml")
    with open(yaml_path, "w") as f:
        f.write(CLI_YAML.format(root=str(tmp_path)))
    features = _features(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpretrain.main([yaml_path, "version=pre", f"feature_folder={features}",
                        "input_features=spectrogram"])


@pytest.mark.parametrize("dtype", [np.uint8, np.float16, np.int16,
                                   np.float32])
def test_stage_cast_matches_jax(dtype):
    rng = np.random.RandomState(1)
    a = np.concatenate([rng.uniform(-1.2, 1.2, 500), [0.0, 1.0]]
                       ).astype(np.float32)
    for key in ("spectrogram", "audio"):
        got = tharness._stage_cast(dtype, key)({key: a, "n": 1})
        ref = jharness._stage_cast(dtype, key)({key: a, "n": 1})
        assert got[key].dtype == ref[key].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got[key], ref[key])
        assert got["n"] == 1


def test_device_batch_drops_host_keys_and_weights_padding(tmp_path):
    exp = _exp(tconfig, str(tmp_path), str(tmp_path), "o",
               upload_dtype="uint8")
    trainer = tharness.Trainer(exp, device="cpu")
    batch = {"spectrogram": np.full((3, 1, 4, 16), 0.5, np.float32),
             "upper": np.zeros((3, 2, 8), np.int32),
             "names": ["a", "b", "b"], "versions": [0, 0, 0], "n_real": 2}
    dev = trainer._device_batch(batch, train=True)
    assert sorted(dev) == ["sample_weight", "spectrogram", "upper"]
    assert dev["sample_weight"].tolist() == [1.0, 1.0, 0.0]
    assert dev["spectrogram"].dtype == np.uint8
    assert trainer._device_batch(batch)["spectrogram"].dtype == np.float32
    with pytest.raises(ValueError, match="data-parallel"):
        trainer._device_batch(dict(batch, local_rows=(0, 2)))
    no_buckets = types.SimpleNamespace(bucket_tokens=0)
    assert tharness.Trainer._bucketed(no_buckets, batch) is batch
