"""The port's copies of the training harness's host modules against their
originals in the JAX package: the datasets and the DataLoader (both
feature modes, the ASAP layout, padding of the final batch, the transform
hook, per-host shards, the prefetch thread), the metrics, the NewBob
scheduler, the train logger, the config snapshot, the int16 helpers and
the step timer. Same inputs, made from seeds; the outputs must be equal."""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest

import piano_a2s_tpu.config as jconfig
import piano_a2s_tpu.data.datasets as jdata
import piano_a2s_tpu.train.logger as jlogger
import piano_a2s_tpu.train.metrics as jmetrics
import piano_a2s_tpu.train.schedulers as jsched
import piano_a2s_tpu.utils.audio as jaudio
import piano_a2s_tpu.utils.profiling as jprof
import piano_a2s_tpu_torch.config as tconfig
import piano_a2s_tpu_torch.data.datasets as tdata
import piano_a2s_tpu_torch.train.logger as tlogger
import piano_a2s_tpu_torch.train.metrics as tmetrics
import piano_a2s_tpu_torch.train.schedulers as tsched
import piano_a2s_tpu_torch.utils.audio as taudio
import piano_a2s_tpu_torch.utils.profiling as tprof
from conftest import REPO_ROOT
from piano_a2s_tpu_torch.train.synthetic import write_clips
from test_harness_e2e import _make_fixture

MAX_LENGTH = (8, 6)
FRAMES = 24
SAMPLES = (FRAMES - 1) * 160


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two versions of spectrograms and of audio (version 1's clips stored
    as float32, version 0's as int16) in the synthetic layout, and an ASAP
    layout of audio."""
    root = str(tmp_path_factory.mktemp("corpus"))
    for v in (0, 1):
        _make_fixture(root, "train", v, n_songs=5, seed=v)
        write_clips(os.path.join(root, "train", str(v)), 5, seed=10 + v,
                    samples=(SAMPLES - 800, SAMPLES + 300), upper=(1, 7),
                    lower=(1, 5), bars=2)
    audio_dir = os.path.join(root, "train", "1", "audio")
    for f in os.listdir(audio_dir):
        path = os.path.join(audio_dir, f)
        np.save(path, taudio.pcm16_to_float(np.load(path)))
    for split, n in (("train", 3), ("test", 2)):
        write_clips(os.path.join(root, "asap", split), n, seed=20 + n,
                    samples=(SAMPLES - 500, SAMPLES), upper=(1, 7),
                    lower=(1, 5), bars=2)
    return root


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            if isinstance(r[k], np.ndarray):
                assert g[k].dtype == r[k].dtype, k
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            else:
                assert g[k] == r[k], k


def _both(make):
    """The batches of ``make(module)`` for the port and the JAX package."""
    return [list(make(mod)) for mod in (tdata, jdata)]


@pytest.mark.parametrize("features", ["spectrogram", "audio"])
@pytest.mark.parametrize("pad", [True, False])
def test_train_loader_batches_equal(corpus, features, pad):
    def make(mod):
        ds = mod.SyntheticTrainDataset(
            corpus, "train", versions=[0, 1],
            rng=np.random.RandomState(3), max_frame_num=FRAMES,
            max_length=MAX_LENGTH, input_features=features,
            max_samples=SAMPLES)
        return mod.DataLoader(ds, 2, shuffle=True, seed=5,
                              pad_final_batch=pad)

    got, ref = _both(make)
    _assert_batches_equal(got, ref)
    assert got[-1]["n_real"] == 1
    assert len(got[-1]["names"]) == (2 if pad else 1)
    if features == "audio":
        # a batch mixing the versions' int16 and float32 clips is float32
        dtypes = {b["audio"].dtype for b in got}
        assert np.dtype(np.float32) in dtypes


@pytest.mark.parametrize("features", ["spectrogram", "audio"])
def test_test_loader_and_shard_equal(corpus, features):
    def make(mod, shard=None):
        ds = mod.SyntheticTestDataset(
            corpus, "train", versions=(0, 1), max_frame_num=FRAMES,
            max_length=MAX_LENGTH, input_features=features,
            max_samples=SAMPLES)
        return mod.DataLoader(ds, 4, shard=shard, prefetch=0)

    got, ref = _both(make)
    _assert_batches_equal(got, ref)
    assert len(got) == 3 and got[-1]["n_real"] == 2
    got, ref = _both(lambda mod: make(mod, shard=(1, 2)))
    _assert_batches_equal(got, ref)
    assert got[0]["local_rows"] == (2, 4)
    assert got[0][features].shape[0] == 2


def test_asap_loader_equal(corpus):
    def make(mod):
        ds = mod.ASAPDataset(os.path.join(corpus, "asap"), "train",
                             max_frame_num=FRAMES, max_length=MAX_LENGTH,
                             input_features="audio", max_samples=SAMPLES)
        loader = mod.DataLoader(ds, 2, shuffle=True, seed=1)
        loader.transform = lambda b: dict(b, audio=b["audio"][:, ::2])
        return loader

    got, ref = _both(make)
    _assert_batches_equal(got, ref)
    assert all(v == "asap" for b in got for v in b["versions"])
    assert got[0]["audio"].dtype == np.int16
    assert got[0]["audio"].shape == (2, SAMPLES // 2)
    assert got[0]["upper"].shape == (2, 2, MAX_LENGTH[0])
    with pytest.raises(FileNotFoundError, match="input_features='audio'"):
        tdata.ASAPDataset(corpus, "test", input_features="audio")


def test_padding_contract_equal(corpus):
    kw = dict(max_frame_num=FRAMES, max_length=MAX_LENGTH)
    t = tdata.SyntheticTestDataset(corpus, "train", versions=(0,), **kw)
    j = jdata.SyntheticTestDataset(corpus, "train", versions=(0,), **kw)
    for score in ([[1, 2, 3], list(range(12)), [4]], []):
        for cap in (3, 8):
            got, ref = t.pad_score(score, cap), j.pad_score(score, cap)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    padded, lens = t.pad_score([[5, 6]], 6)
    assert padded[0].tolist() == [5, 6, t.eos_id] + [t.pad_id] * 3
    assert lens.tolist() == [2]
    assert tdata.load_time_signatures() == jdata.load_time_signatures()


class _Dummy:
    def __len__(self):
        return 64

    def __getitem__(self, i):
        return {"spectrogram": np.zeros((1, 2, 2), np.float32),
                "time_sig": np.zeros(2, np.int32),
                "key": np.zeros(2, np.int32),
                "upper": np.zeros((2, 3), np.int32),
                "upper_lengths": np.ones(2, np.int32),
                "lower": np.zeros((2, 3), np.int32),
                "lower_lengths": np.ones(2, np.int32),
                "name": f"s{i}", "version": 0}


def test_abandoned_iterator_stops_its_thread():
    """Leaving a prefetching loader after one batch stops its producer
    thread, which would otherwise block on a full queue."""
    before = threading.active_count()
    for _ in range(5):
        it = iter(tdata.DataLoader(_Dummy(), 2, prefetch=2))
        next(it)
        it.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= before


def test_loader_thread_error_reaches_the_consumer():
    class Broken(_Dummy):
        def __getitem__(self, i):
            if i == 3:
                raise OSError("disk")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="disk"):
        list(tdata.DataLoader(Broken(), 2, prefetch=2))


# --- metrics, scheduler, logger ----------------------------------------------

def test_metrics_equal():
    rng = np.random.RandomState(0)
    for _ in range(30):
        a = rng.randint(0, 6, rng.randint(0, 30)).tolist()
        b = rng.randint(0, 6, rng.randint(0, 30)).tolist()
        assert tmetrics.edit_distance(a, b) == jmetrics.edit_distance(a, b)
        assert tmetrics.macro_f1(a, b[:len(a)] + a[len(b):]) == \
            jmetrics.macro_f1(a, b[:len(a)] + a[len(b):])
    for truth, hyp in (("a b c", "a x c d"), ("", "a"), ("", ""),
                       ("4c \n = \n 8d", "4c 8d")):
        assert tmetrics.word_error_rate(truth, hyp) == \
            jmetrics.word_error_rate(truth, hyp)
    pred = {f"c{i}": [rng.randint(0, 173, rng.randint(0, 9)).tolist()
                      for _ in range(3)] for i in range(4)}
    tgt = {k: [rng.randint(0, 173, rng.randint(1, 9)).tolist()
               for _ in range(3)] for k in pred}
    assert tmetrics.calculate_wer(pred, tgt) == \
        jmetrics.calculate_wer(pred, tgt)
    kp = {k: rng.randint(0, 14, 5).tolist() for k in pred}
    kt = {k: rng.randint(0, 14, 5).tolist() for k in pred}
    assert tmetrics.calculate_f1(kp, kt) == jmetrics.calculate_f1(kp, kt)
    seq = list(range(0, 173, 7))
    assert tmetrics.idx2string(seq) == jmetrics.idx2string(seq)
    assert tmetrics.EOS == jmetrics.EOS


def test_newbob_and_teacher_forcing_equal():
    wers = [1.0, 0.9, 0.899, 0.95, 0.5, 0.4999, 0.6]
    for patient in (0, 1):
        t = tsched.NewBobScheduler(1.0, 0.8, 0.0025, patient)
        j = jsched.NewBobScheduler(1.0, 0.8, 0.0025, patient)
        for w in wers:
            assert t(w) == j(w)
            assert t.state_dict() == j.state_dict()
        fresh = tsched.NewBobScheduler(1.0, 0.8, 0.0025, patient)
        fresh.load_state_dict(j.state_dict())
        assert fresh(0.3) == j(0.3)
    for epoch in (0, 1, 7, 30):
        assert tsched.teacher_forcing_ratio(0.7, 0.99, epoch) == \
            jsched.teacher_forcing_ratio(0.7, 0.99, epoch)


def test_train_logger_lines_byte_identical(tmp_path):
    meta = {"epoch": 3, "lr": 0.8, "epoch_time": 12.5, "step_ms": 1234.56}
    train = {"loss": 15.25, "time_loss": 0.00123, "teacher_forcing_ratio": 0.7}
    valid = {"loss": 14.0, "WER": 1.3797, "key_f1": 0.0, "zero": 0}
    paths = {}
    for name, mod in (("port", tlogger), ("jax", jlogger)):
        paths[name] = str(tmp_path / name / "log.txt")
        log = mod.FileTrainLogger(paths[name])
        log.log_stats(meta, train_stats=train, valid_stats=valid)
        log.log_stats({"stage": "test"}, test_stats=valid)
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()


# --- config, audio, timing ---------------------------------------------------

@pytest.mark.parametrize("name", ["pretrain", "finetune"])
def test_snapshot_and_dataset_kwargs_equal(tmp_path, name):
    path = f"{REPO_ROOT}/configs/{name}.yaml"
    overrides = ["workspace=/w", "input_features=audio", "max_length=[8,6]",
                 "bucket_tokens=16"]
    for ov in (None, overrides):
        ref = jconfig.load_experiment(path, ov)
        got = tconfig.load_experiment(path, ov)
        assert got.dataset_kwargs() == ref.dataset_kwargs()
        a = got.snapshot(str(tmp_path / "port"))
        b = ref.snapshot(str(tmp_path / "jax"))
        assert os.path.basename(a) == "hyperparams.yaml"
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert got.dataset_kwargs()["input_features"] == "audio"
    assert dataclasses.asdict(tconfig.load_experiment(a)) == \
        dataclasses.asdict(got)


def test_int16_helpers_equal():
    rng = np.random.RandomState(2)
    x = np.concatenate([rng.uniform(-1, 1, 1000), [-1.0, 1.0, 0.0]]
                       ).astype(np.float32)
    for fn in ("to_pcm16", "float32_to_int16"):
        got, ref = getattr(taudio, fn)(x), getattr(jaudio, fn)(x)
        assert got.dtype == ref.dtype == np.int16
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(taudio.to_pcm16(1.5 * x),
                                  jaudio.to_pcm16(1.5 * x))


def test_step_timer_summary_equal():
    timers = (tprof.StepTimer(), jprof.StepTimer())
    for timer in timers:
        timer.durations = {"train_step": [0.5, 0.25]}
        mark = timer.mark()
        timer.durations["train_step"] += [1.0, 2.0]
        timer.durations["eval"] = [3.0]
    got, ref = timers[0], timers[1]
    assert got.summary() == ref.summary()
    assert got.summary(since=mark) == ref.summary(since=mark)
    assert got.summary(since=mark)["train_step"]["count"] == 2
    with got.time("cpu_region") as c:
        c["x"] = np.zeros(1)
    assert got.summary()["cpu_region"]["count"] == 1
