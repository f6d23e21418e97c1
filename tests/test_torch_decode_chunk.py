"""The decode's stop groups (``decode_chunk``) against the JAX package's
chunked decode on the CPU.

The JAX package decodes each group of ``chunk`` clips in its own loop
(lax.map); the port keeps a done flag per (staff, group) in one loop. Every
clip's math is its own, so the two agree wherever the stop groups do. The
models here are weak (a small EOS bias, the ConvStack's weights scaled so
that clips differ), so that the groups stop at different steps and a
chunked decode differs from the unchunked one: each test checks that it
does, so that it can fail. Float32 tokens and lengths must be equal and
log-probs within 1e-5; bfloat16 at tests/test_torch_bf16.py's tolerance.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import piano_a2s_tpu.config as jconfig
import piano_a2s_tpu.data.datasets as jdata
import piano_a2s_tpu.train.harness as jharness
import piano_a2s_tpu_torch.config as tconfig
import piano_a2s_tpu_torch.data.datasets as tdata
import piano_a2s_tpu_torch.train.harness as tharness
from piano_a2s_tpu.infer import Transcriber as JaxTranscriber
from piano_a2s_tpu.models import ModelConfig, init_params, init_state
from piano_a2s_tpu.models import score_transcription as jst
from piano_a2s_tpu_torch import infer as tinfer
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import state_dict_from_jax
from test_harness_e2e import _make_fixture
from test_torch_bf16 import ATOL_LOGP as ATOL_LOGP_BF16
from test_torch_harness import TINY
from test_torch_infer import CFG as ICFG
from test_torch_infer import FRAMES, TCFG as TICFG, TVQT, VQT

torch.set_num_threads(2)

# tests/test_decode_chunk.py's configuration.
CFG = ModelConfig(freq_bins=16, conv_feature_size=32, hidden_size=16,
                  max_bars=2, max_length=(8, 6), note_emb_size=8,
                  staff_emb_size=8)
TCFG = tst.ModelConfig(**{f: getattr(CFG, f) for f in
                          CFG.__dataclass_fields__})
ATOL_LOGP = 1e-5
# The weak model: the EOS logit raised a little, the ConvStack's weights
# scaled so that unit-scale inputs leave the conv features alive.
EOS_BIAS, CONV_SCALE = 0.5, 3.0


def _weak(cfg, seed, eos_bias=EOS_BIAS, conv_scale=1.0):
    params = jax.tree.map(np.array, init_params(jax.random.PRNGKey(seed),
                                                cfg))
    for d in ("upper", "lower"):
        params["decoder"][d]["out"]["b"][cfg.eos] += eos_bias
    params["convstack"] = jax.tree.map(lambda w: w * conv_scale,
                                       params["convstack"])
    return params, jax.tree.map(np.asarray, init_state(cfg))


def _tcfg(cfg):
    return tst.ModelConfig(**{f: getattr(cfg, f)
                              for f in cfg.__dataclass_fields__})


# --- the chunk rules ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pick_decode_chunk_matches_jax(dtype):
    """The port's rules against the JAX package's over batches 1-70."""
    t_dt = torch.bfloat16 if dtype == "bfloat16" else None
    j_dt = jnp.bfloat16 if dtype == "bfloat16" else None
    for chunk in (None, 0, False, "auto", 5, 16):
        for batch in range(1, 71):
            assert tst.pick_decode_chunk(chunk, batch, t_dt) == \
                jst.pick_decode_chunk(chunk, batch, j_dt), (chunk, batch)
    assert tst.pick_decode_chunk(16, 24) == 12
    assert tst.pick_decode_chunk(16, 17) is None
    assert tst.pick_decode_chunk("auto", 64, torch.bfloat16) == 32


# --- the forward -------------------------------------------------------------

def _spec(b=8, seed=0):
    """Rows of different scales, so that the clips decode differently."""
    rng = np.random.RandomState(seed)
    scale = rng.choice([0.0, 1, 3, 10, 30, 100], (b, 1, 1, 1))
    return (rng.randn(b, 1, 20, 16) * scale).astype(np.float32)


def _jax_forward(params, state, spec, chunk, dtype):
    (ts, key, up, low, aux), _ = jst.forward(
        params, state, jnp.asarray(spec), jax.random.PRNGKey(0), cfg=CFG,
        train=False, decode_dtype=dtype, decode_chunk=chunk)
    return [np.asarray(a) for a in (ts, key, up, low)], {
        k: np.asarray(v) for k, v in aux.items()}


def _port_forward(model, spec, chunk, dtype):
    ts, key, up, low, aux = model(torch.from_numpy(spec), decode_dtype=dtype,
                                  decode_chunk=chunk)
    return [a.float().numpy() for a in (ts, key, up, low)], {
        k: v.numpy() for k, v in aux.items()}


def _group_stops(logp, chunk):
    """Per (bar, group): the steps a staff ran, read from its log-prob
    buffer (zero after its stop)."""
    ran = (np.abs(logp).sum(-1) > 0).sum(-1)              # (B, bars)
    return ran.reshape(-1, chunk, ran.shape[1]).max(axis=1).T  # (bars, G)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_chunked_matches_jax(dtype):
    """forward(decode_chunk=2) on 8 clips: 4 stop groups, which stop at
    different steps, equal to the JAX package's chunked forward; and not
    equal to the port's one-group decode."""
    t_dt = torch.bfloat16 if dtype == "bfloat16" else None
    j_dt = jnp.bfloat16 if dtype == "bfloat16" else None
    atol = ATOL_LOGP_BF16 if t_dt else ATOL_LOGP
    params, state = _weak(CFG, 0)
    model = tst.ScoreTranscription(TCFG).eval()
    model.load_state_dict(state_dict_from_jax(params, state, TCFG),
                          strict=True)
    spec = _spec()
    ref = _jax_forward(params, state, spec, 2, j_dt)
    got = _port_forward(model, spec, 2, t_dt)
    stops = _group_stops(ref[0][2], 2)
    print(f"{dtype}: upper staff steps per (bar, group) {stops.tolist()}")
    assert any(len(set(bar)) > 1 for bar in stops.tolist())
    np.testing.assert_array_equal(_group_stops(got[0][2], 2), stops)
    for name, g, r in zip(("time_sig", "key"), got[0][:2], ref[0][:2]):
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1),
                                      err_msg=name)
    for k in ref[1]:
        np.testing.assert_array_equal(got[1][k], ref[1][k], err_msg=k)
    for name, g, r in zip(("upper", "lower"), got[0][2:], ref[0][2:]):
        np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=name)
    one_group = _port_forward(model, spec, None, t_dt)
    assert any(not np.array_equal(one_group[1][k], got[1][k])
               for k in got[1])


def test_chunk_ignored_with_ground_truth():
    """The teacher-forced forward takes no chunk (as the JAX package's,
    which ignores it with ground truth): the same outputs with and
    without one."""
    params, state = _weak(CFG, 1)
    model = tst.ScoreTranscription(TCFG).eval()
    model.load_state_dict(state_dict_from_jax(params, state, TCFG),
                          strict=True)
    rng = np.random.RandomState(0)
    gt = tuple(torch.from_numpy(a) for a in (
        rng.randint(0, 7, (4, 2)), rng.randint(0, 14, (4, 2)),
        rng.randint(0, 140, (4, 2, 8)), np.full((4, 2), 4),
        rng.randint(0, 140, (4, 2, 6)), np.full((4, 2), 3)))
    spec = torch.from_numpy(_spec(4, 1))
    with torch.no_grad():
        a = model(spec, ground_truth=gt, decode_chunk=2)
        b = model(spec, ground_truth=gt)
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


# --- the Transcriber ---------------------------------------------------------

def _clips(n, seed):
    rng = np.random.RandomState(seed)
    amps = rng.choice([0.001, 0.01, 0.1, 0.5, 1.0], n)
    return [(a * rng.randn(m)).astype(np.float32)
            for a, m in zip(amps, rng.randint(4000, 16000, n))]


@pytest.fixture(scope="module")
def weak_serving():
    params, state = _weak(ICFG, 1, conv_scale=CONV_SCALE)
    return params, state, state_dict_from_jax(params, state, TICFG)


def test_transcriber_default_chunks_as_jax(weak_serving):
    """20 clips, padded to 32: the default "auto" decodes two stop groups
    of 16, as the JAX Transcriber's default does; without the chunk a clip
    comes out otherwise."""
    params, state, sd = weak_serving
    clips = _clips(20, 1)
    port = tinfer.Transcriber(sd, TICFG, TVQT, max_frame_num=FRAMES,
                              device="cpu")
    assert port.decode_chunk == "auto"
    got = port.transcribe_batch(clips)
    ref = JaxTranscriber(params, state, ICFG, VQT,
                         max_frame_num=FRAMES).transcribe_batch(clips)
    assert got == ref
    one_group = tinfer.Transcriber(sd, TICFG, TVQT, max_frame_num=FRAMES,
                                   device="cpu", decode_chunk=None)
    assert one_group.transcribe_batch(clips) != got


def test_mesh_transcriber_chunks_each_shard_as_jax(weak_serving):
    """32 clips on a mesh with decode_chunk=2, picked against each shard's
    rows: the port's 2 shards of 16 and the JAX package's 8 of 4 both
    decode stop groups of 2 clips, so their results are equal; the port's
    one group per shard comes out otherwise."""
    params, state, sd = weak_serving
    clips = _clips(32, 5)
    kw = dict(max_frame_num=FRAMES, use_mesh=True)
    port = tinfer.Transcriber(sd, TICFG, TVQT, devices=["cpu"] * 2,
                              decode_chunk=2, **kw)
    got = port.transcribe_batch(clips)
    jax_mesh = JaxTranscriber(params, state, ICFG, VQT, decode_chunk=2, **kw)
    assert jax_mesh.mesh.devices.size == 8
    assert got == jax_mesh.transcribe_batch(clips)
    single = tinfer.Transcriber(sd, TICFG, TVQT, max_frame_num=FRAMES,
                                device="cpu", decode_chunk=2)
    assert single.transcribe_batch(clips) == got
    unchunked = tinfer.Transcriber(sd, TICFG, TVQT, devices=["cpu"] * 2,
                                   decode_chunk=None, **kw)
    assert unchunked.transcribe_batch(clips) != got


# --- the Trainer's eval stage ------------------------------------------------

def _trainer_exp(mod, root, name, **extras):
    out = os.path.join(root, name)
    exp = mod.ExperimentConfig(
        workspace=root, output_folder=out,
        feature_folder=os.path.join(root, "features"),
        save_folder=os.path.join(out, "save"),
        train_log=os.path.join(out, "train_log.txt"),
        **dict(TINY, batch_size=4))
    exp.extras.update(extras)
    return exp


def _test_stage(trainer, mod, exp):
    """The test stage's stats and result records (no checkpoint: the
    Trainer evaluates its own weights)."""
    ds = mod.SyntheticTestDataset(exp.feature_folder, "test", versions=[0],
                                  max_frame_num=exp.max_frame_num,
                                  max_length=exp.max_length)
    stats = trainer.evaluate(mod.DataLoader(ds, exp.batch_size))
    folder = os.path.join(exp.output_folder, "results", "test")
    return stats, {f: open(os.path.join(folder, f)).read()
                   for f in sorted(os.listdir(folder))}


def test_trainer_eval_decode_chunk_matches_jax(tmp_path):
    """extras eval_decode_chunk: 2 on an eval batch of 4 of a weak model:
    the port's test stage (WER, F1, losses, the result records) equals the
    JAX Trainer's. Without the option the loss differs: the free-running
    log-probs after a clip's first EOS are its stop group's (the records
    cut each staff at its first EOS)."""
    root = str(tmp_path)
    _make_fixture(os.path.join(root, "features"), "test", 0, n_songs=4,
                  seed=2)
    jtrainer = jharness.Trainer(_trainer_exp(jconfig, root, "jax",
                                             eval_decode_chunk=2))
    params, state = _weak(jtrainer.cfg, 0, eos_bias=1.1,
                          conv_scale=CONV_SCALE)
    jtrainer.params, jtrainer.state = (jax.tree.map(jnp.asarray, params),
                                       jax.tree.map(jnp.asarray, state))
    tcfg = _tcfg(jtrainer.cfg)
    sd = state_dict_from_jax(params, state, tcfg)
    ref = _test_stage(jtrainer, jdata, jtrainer.exp)
    runs = {}
    for name, extras in (("port", {"eval_decode_chunk": 2}),
                         ("one_group", {})):
        exp = _trainer_exp(tconfig, root, name, **extras)
        trainer = tharness.Trainer(exp, device="cpu", state_dict=sd)
        runs[name] = _test_stage(trainer, tdata, exp)
    (stats, records), (one_stats, _) = runs["port"], runs["one_group"]
    assert list(stats) == list(ref[0])
    for k, v in ref[0].items():
        if "loss" in k:
            np.testing.assert_allclose(stats[k], v, rtol=1e-5, err_msg=k)
        else:
            assert stats[k] == v, k
    assert records == ref[1]
    assert one_stats["loss"] != stats["loss"]

