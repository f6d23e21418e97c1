"""The port's multi-device paths on the CPU: batch-sharded serving
(Transcriber(use_mesh=True)) and data-parallel training over a gloo group
of two ranks (tests/_torch_dp_worker.py, one process each).

Serving is held against the port's single Transcriber and the JAX
package's mesh Transcriber on its 8 virtual devices. The data-parallel
BatchNorm, train steps and eval step are held against one rank on the
joined rows in float64 (1e-12 for BatchNorm, 1e-10 for a step, dropout on:
the sums are only taken in another order) and the step against the JAX
package's step over an 8-device mesh (1e-8, dropout patched out in both,
as tests/test_torch_train.py holds one device). The data-parallel Trainer
is held against one process (float32: losses within 1e-5 relative, the
parameter sum within 1e-4, the tolerances of tests/test_multihost.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import piano_a2s_tpu.ops.layers as jL
import piano_a2s_tpu.parallel as jpar
import piano_a2s_tpu_torch.ops.layers as tL
from conftest import REPO_ROOT
from piano_a2s_tpu.infer import Transcriber as JaxTranscriber
from piano_a2s_tpu.models import init_params, init_state
from piano_a2s_tpu.train import step as jstep
from piano_a2s_tpu_torch import infer as tinfer
from piano_a2s_tpu_torch import parallel
from piano_a2s_tpu_torch.config import ExperimentConfig
from piano_a2s_tpu_torch.data.datasets import (DataLoader,
                                               SyntheticTestDataset,
                                               SyntheticTrainDataset)
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import (init_state_dict,
                                                state_dict_from_jax)
from piano_a2s_tpu_torch.train import step as tstep
from piano_a2s_tpu_torch.train.harness import Trainer
from test_harness_e2e import _make_fixture
from test_torch_infer import CFG as SCFG
from test_torch_infer import FRAMES, TCFG as STCFG, TVQT, VQT, _clips
from test_torch_train import CFG, TCFG, _batch, _weights
from test_torch_train import x64  # noqa: F401 (fixture)

torch.set_num_threads(2)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dp_worker.py")
WORLD = 2
TIMEOUT_S = 240  # per spawned rank
ATOL_BN = 1e-12
ATOL_STEP = 1e-10
ATOL_JAX = 1e-8
RTOL_TRAINER_LOSS, RTOL_TRAINER_PARAMS = 1e-5, 1e-4
# The bf16 step: its BatchNorm statistics are float32 sums taken in
# another order on two ranks, which can move a bf16 activation by one ulp
# (2^-8, 0.4% relative), and the update with it. Observed: the loss within
# 1.7e-4 relative, the parameters' difference 0.45% of the step's update
# (L2 over all tensors).
RTOL_BF16_LOSS, BF16_UPDATE_SHARE = 1e-3, 0.02


def _launch(workdir, mode, world=WORLD):
    """Run ``world`` ranks of the worker in ``mode``; each must exit 0
    within TIMEOUT_S. Returns their outputs."""
    init = os.path.join(workdir, f"init_{mode}")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), init, workdir, mode],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO_ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


# --- rows ----------------------------------------------------------------

def test_local_rows_layout():
    """Microbatch m is the global rows [m M, (m+1) M), M = B/A, and rank r
    owns [floor(r M/N), floor((r+1) M/N)) of each; A = 1 gives the
    contiguous range of the JAX package's per-host loading. Where N does
    not divide M the slices differ by a row; where M < N some ranks own
    none. Only the shapes the JAX package refuses raise: A or N not
    dividing B."""
    assert parallel.local_rows(1, 2, 8).tolist() == [4, 5, 6, 7]
    assert parallel.local_rows(0, 2, 8, 2).tolist() == [0, 1, 4, 5]
    assert parallel.local_rows(1, 2, 8, 2).tolist() == [2, 3, 6, 7]
    assert parallel.local_rows(0, 1, 6, 3).tolist() == list(range(6))
    joined = np.sort(np.concatenate([parallel.local_rows(r, 4, 16, 2)
                                     for r in range(4)]))
    assert joined.tolist() == list(range(16))
    # N does not divide M = 3
    assert parallel.local_rows(0, 2, 6, 2).tolist() == [0, 3]
    assert parallel.local_rows(1, 2, 6, 2).tolist() == [1, 2, 4, 5]
    # M = 1 < N = 2: rank 0 owns no row
    assert parallel.local_rows(0, 2, 4, 4).tolist() == []
    assert parallel.local_rows(1, 2, 4, 4).tolist() == [0, 1, 2, 3]
    for world, batch, accum in ((4, 4, 2), (4, 8, 8), (3, 6, 2)):
        joined = np.sort(np.concatenate([
            parallel.local_rows(r, world, batch, accum)
            for r in range(world)]))
        assert joined.tolist() == list(range(batch)), (world, batch, accum)
    with pytest.raises(ValueError, match=r"B=6, A=4, N=2"):
        parallel.local_rows(0, 2, 6, 4)
    with pytest.raises(ValueError, match=r"B=6, A=1, N=4"):
        parallel.local_rows(0, 4, 6)


def test_step_rows_stand_in_where_a_rank_owns_none():
    """A rank computes its own rows, or, where it owns none of a
    microbatch, one stand-in row of each: the global row at its offset.
    step_rows gives (rows, offset in the microbatch, owned)."""
    rows, start, owned = parallel.step_rows(1, 2, 6, 2)
    assert (rows.tolist(), start, owned) == ([1, 2, 4, 5], 1, True)
    rows, start, owned = parallel.step_rows(0, 2, 4, 4)
    assert (rows.tolist(), start, owned) == ([0, 1, 2, 3], 0, False)
    rows, start, owned = parallel.step_rows(2, 4, 4, 2)
    assert (rows.tolist(), start, owned) == ([1, 3], 1, False)
    with pytest.raises(ValueError, match=r"B=6, A=4, N=2"):
        parallel.step_rows(0, 2, 6, 4)


@pytest.mark.parametrize("fn", ["batch_norm_train", "batch_norm_relu_train"])
@pytest.mark.parametrize("weight", [(0.0, 0.0, 0.0), (1.0, 0.0, 1.0)])
def test_stand_in_rows_count_in_no_batch_norm_statistic(fn, weight):
    """A stand-in row (weight 0, counted 0) leaves the BatchNorm output,
    running statistics and gradients of the real rows as they are without
    it, also where every weight is 0 and the statistics fall back to the
    unweighted ones (which count every row that is not a stand-in)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 4, 5, 6))
    cot = torch.from_numpy(rng.randn(3, 4, 5, 6))
    w = torch.tensor(weight, dtype=torch.float64)
    outs = []
    for stand_in in (False, True):
        bn = torch.nn.BatchNorm2d(4).double()
        xi = (torch.cat([x, x[:1]]) if stand_in else x.clone()
              ).requires_grad_(True)
        wi = torch.cat([w, w.new_zeros(1)]) if stand_in else w
        counted = (torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=torch.float64)
                   if stand_in else None)
        y = getattr(tL, fn)(xi, bn, (0, 2, 3), wi, counted=counted)[:3]
        (y * cot).sum().backward()
        outs.append((y.detach(), xi.grad[:3], bn.running_mean,
                     bn.running_var))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=ATOL_BN, rtol=0)


def test_sharded_loader_contract(tmp_path):
    """shard=(rank, world): the global batch plan and targets on every
    rank, each rank's feature rows by local_rows (with accum_steps, its
    slice of every microbatch), together the replicated batch."""
    root = str(tmp_path / "features")
    _make_fixture(root, "train", 0, n_songs=8)

    def loader(shard, accum=1):
        ds = SyntheticTrainDataset(root, "train", versions=[0],
                                   max_frame_num=24, max_length=(8, 6),
                                   rng=np.random.RandomState(0))
        return DataLoader(ds, 8, shuffle=True, seed=0, shard=shard,
                          accum_steps=accum, prefetch=0)

    (ref,) = list(loader(None))
    for accum in (1, 2, 8):
        got = [list(loader((r, 2), accum))[0] for r in range(2)]
        for r, b in enumerate(got):
            rows = parallel.step_rows(r, 2, 8, accum)[0]
            np.testing.assert_array_equal(b["local_rows"], rows)
            np.testing.assert_array_equal(b["spectrogram"],
                                          ref["spectrogram"][rows])
            assert b["names"] == ref["names"] and b["n_real"] == 8
            for k in ("time_sig", "key", "upper", "upper_lengths", "lower",
                      "lower_lengths"):
                np.testing.assert_array_equal(b[k], ref[k])
    with pytest.raises(ValueError, match="must divide batch_size=6"):
        DataLoader(loader(None).dataset, 6, shard=(0, 2), accum_steps=4)


# --- serving -------------------------------------------------------------

def _serving_weights(eos_bias):
    """tests/test_infer_mesh.py's weights, the EOS logit raised by
    ``eos_bias``, as numpy trees."""
    params = jax.tree.map(np.array, init_params(jax.random.PRNGKey(0), SCFG))
    for d in ("upper", "lower"):
        params["decoder"][d]["out"]["b"][SCFG.eos] += eos_bias
    return params, jax.tree.map(np.asarray, init_state(SCFG))


def test_mesh_transcriber_matches_single_and_jax():
    """The twin of tests/test_infer_mesh.py: on an EOS-confident model the
    8-shard Transcriber equals the port's single one and the JAX package's
    mesh Transcriber, for 3 clips padded to 8 and through the stream at
    batch 8; the stream rejects batch 3 at the call."""
    params, state = _serving_weights(5.0)
    sd = state_dict_from_jax(params, state, STCFG)
    single = tinfer.Transcriber(sd, STCFG, TVQT, max_frame_num=FRAMES,
                                device="cpu")
    meshy = tinfer.Transcriber(sd, STCFG, TVQT, max_frame_num=FRAMES,
                               use_mesh=True, devices=["cpu"] * 8)
    jax_mesh = JaxTranscriber(params, state, SCFG, VQT, max_frame_num=FRAMES,
                              use_mesh=True)
    assert jax_mesh.mesh.devices.size == len(meshy.devices) == 8
    clips = _clips(0, (12000, 12000, 12000))
    audio, n = meshy.prepare_batch(clips)
    assert n == 3 and audio.shape[0] == 8
    got = meshy.transcribe_batch(clips)
    assert got == single.transcribe_batch(clips)
    assert got == jax_mesh.transcribe_batch(clips)
    assert list(meshy.transcribe_stream(clips, batch_size=8,
                                        depth=2)) == got
    assert list(jax_mesh.transcribe_stream(clips, batch_size=8)) == got
    with pytest.raises(ValueError, match="8-device mesh"):
        meshy.transcribe_stream(clips, batch_size=3)


def test_mesh_shards_stop_on_their_own():
    """Without the EOS bias the decodes stop at different steps: each
    shard of the mesh equals that shard run alone (no collective between
    the shards), as the JAX package's shard_map serves."""
    params, state = _serving_weights(0.0)
    sd = state_dict_from_jax(params, state, STCFG)
    single = tinfer.Transcriber(sd, STCFG, TVQT, max_frame_num=FRAMES,
                                device="cpu")
    meshy = tinfer.Transcriber(sd, STCFG, TVQT, max_frame_num=FRAMES,
                               use_mesh=True, devices=["cpu"] * 2)
    clips = _clips(7, (12000, 5000, 16000, 9000))
    got = meshy.transcribe_batch(clips)
    assert got == (single.transcribe_batch(clips[:2])
                   + single.transcribe_batch(clips[2:]))


def test_mesh_needs_cuda_or_devices(monkeypatch):
    sd = init_state_dict(STCFG, 0)
    with pytest.raises(ValueError, match="use_mesh"):
        tinfer.Transcriber(sd, STCFG, TVQT, device="cpu", devices=["cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="visible CUDA devices"):
        tinfer.Transcriber(sd, STCFG, TVQT, use_mesh=True)


# --- data-parallel units (one launch of two ranks) -----------------------

def _bn_cases():
    """BatchNorm inputs, float64: rank 1's rows all weight 0 (its local
    statistics would fall back to unweighted ones, the global ones must
    not), every weight 0 (the global fallback), and the (B, T, F) layout
    of the ConvStack's out_bn."""
    rng = np.random.RandomState(5)

    def case(shape, axes, weight):
        c = shape[1] if len(shape) == 4 else shape[-1]
        state = {"weight": torch.from_numpy(rng.rand(c) + 0.5),
                 "bias": torch.from_numpy(rng.randn(c)),
                 "running_mean": torch.from_numpy(rng.randn(c)),
                 "running_var": torch.from_numpy(rng.rand(c) + 0.5),
                 "num_batches_tracked": torch.tensor(0)}
        return {"x": torch.from_numpy(rng.randn(*shape) * 3 + 1),
                "cotangent": torch.from_numpy(rng.randn(*shape)),
                "weight": torch.tensor(weight, dtype=torch.float32),
                "axes": axes, "bn_state": state}

    half = [1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0]
    return {"rank1_padding": case((8, 3, 5, 4), (0, 2, 3), half),
            "all_padding": case((8, 3, 5, 4), (0, 2, 3), [0.0] * 8),
            "out_bn": case((8, 5, 6), (0, 1), [1.0] * 7 + [0.0])}


def _train_batch():
    batch = _batch(b=8, seed=3)
    batch["sample_weight"] = np.array([1.0] * 6 + [0.0] * 2, np.float32)
    return batch


# Batches whose microbatches do not split evenly over the two ranks: B=6 at
# A=2 (microbatches of 3, split 1 + 2; one row weighs 0) and B=4 at A=4
# (microbatches of 1 row: rank 0 owns none and computes a stand-in row of
# weight 0), with no row weights in the batch, and with row 0 weighing 0
# (b4_a4_w0: microbatch 0's weights are all 0, so its BatchNorm takes the
# unweighted fallback, which must not count the stand-in either).
UNEVEN = {"b6_a2": (6, 2), "b4_a4": (4, 4), "b4_a4_w0": (4, 4)}


def _uneven_batch(name):
    b = UNEVEN[name][0]
    batch = {k: np.array(v[:b]) for k, v in _train_batch().items()}
    if name == "b4_a4":
        del batch["sample_weight"]
    elif name == "b4_a4_w0":
        batch["sample_weight"][:] = [0.0, 1.0, 1.0, 1.0]
    else:
        batch["sample_weight"][-1] = 0.0
    return batch


def _weak_eval():
    """A weak float64 model whose items emit EOS at different steps, and an
    eval batch of 8 whose rows are scaled from 0 to 200 (unit-scale inputs
    leave this small model's conv features all zero, so its rows would
    decode alike)."""
    sd = init_state_dict(TCFG, 3, dtype=torch.float64)
    for d in ("upper", "lower"):
        sd[f"decoder.{d}_decoder.out.bias"][TCFG.eos] += 1.1
    batch = _batch(b=8, seed=9)
    scale = np.array([0.0, 1, 3, 10, 30, 60, 100, 200])[:, None, None, None]
    batch["spectrogram"] = batch["spectrogram"] * scale
    batch["sample_weight"] = np.array([1.0] * 7 + [0.0], np.float32)
    return sd, batch


def _one_rank_step(state_dict, batch, accum, tf, conv_dtype=None):
    model = tst.ScoreTranscription(TCFG).double()
    model.load_state_dict(state_dict, strict=True)
    if conv_dtype is not None:
        model = model.float()
    t_step, _ = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), accum_steps=accum,
        device="cpu", conv_dtype=conv_dtype)
    out = t_step(model, batch, torch.Generator().manual_seed(0), tf)
    return out, model.state_dict()


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """The two ranks' results of the worker's "units" mode, and its
    inputs."""
    workdir = str(tmp_path_factory.mktemp("dp_units"))
    params, state = _weights()
    weak_sd, eval_batch = _weak_eval()
    inputs = {"cfg": {f: getattr(TCFG, f)
                      for f in TCFG.__dataclass_fields__},
              "weights": state_dict_from_jax(params, state, TCFG),
              "batch": _train_batch(), "bn_cases": _bn_cases(),
              "uneven": {k: (_uneven_batch(k), UNEVEN[k][1])
                         for k in UNEVEN},
              "weak_weights": weak_sd, "eval_batch": eval_batch}
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    _launch(workdir, "units")
    ranks = [torch.load(os.path.join(workdir, f"units_{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return inputs, (params, state), ranks


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0)


@pytest.mark.parametrize("fn", ["batch_norm_train", "batch_norm_relu_train"])
@pytest.mark.parametrize("case", ["rank1_padding", "all_padding", "out_bn"])
def test_bn_across_ranks_equals_joined_rows(units, case, fn):
    """The weighted BatchNorm over two ranks equals one rank's on the
    joined rows: outputs, x's gradient, gamma's and beta's (summed over
    the ranks, as the gradient all-reduce sums them) and the running
    statistics, within 1e-12 in float64."""
    inputs, _, ranks = units
    c = inputs["bn_cases"][case]
    bn = (torch.nn.BatchNorm2d if c["x"].dim() == 4
          else torch.nn.BatchNorm1d)(c["bn_state"]["weight"].numel())
    bn = bn.double()
    bn.load_state_dict(c["bn_state"])
    x = c["x"].clone().requires_grad_(True)
    y = getattr(tL, fn)(x, bn, c["axes"], c["weight"])
    (y * c["cotangent"]).sum().backward()
    got = [r["bn"][(case, fn)] for r in ranks]
    rows = [parallel.local_rows(r, WORLD, 8) for r in range(WORLD)]
    for r, g in enumerate(got):
        _close(g["y"], y.detach()[rows[r]], ATOL_BN)
        _close(g["dx"], x.grad[rows[r]], ATOL_BN)
        _close(g["running_mean"], bn.running_mean, ATOL_BN)
        _close(g["running_var"], bn.running_var, ATOL_BN)
    _close(sum(g["dgamma"] for g in got), bn.weight.grad, ATOL_BN)
    _close(sum(g["dbeta"] for g in got), bn.bias.grad, ATOL_BN)


def _assert_step_equal(got, out, state, atol):
    assert sorted(got["components"]) == sorted(out.components)
    _close(got["loss"], out.loss, atol)
    for k, v in out.components.items():
        _close(got["components"][k], v, atol)
    _close(got["grad_norm"], out.grad_norm, atol)
    assert sorted(got["state"]) == sorted(state)
    for k, v in state.items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_step_equals_one_rank_with_dropout(units, accum):
    """The twin of tests/test_sharded_training.py::test_single_device_
    equals_mesh, with dropout on and tf 0.7: two ranks (the masks drawn at
    the global shape, the microbatches laid out as JAX's reshape, rank 1's
    rows of microbatch 1 all padding) equal one rank within 1e-10; the two
    ranks are identical."""
    inputs, _, ranks = units
    out, state = _one_rank_step(inputs["weights"], inputs["batch"], accum,
                                0.7)
    got = [r[f"dropout_a{accum}"] for r in ranks]
    for g in got:
        _assert_step_equal(g, out, state, ATOL_STEP)
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
    assert float(got[0]["loss"]) == float(got[1]["loss"])


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_step_without_row_weights_equals_one_rank(units, accum):
    """A batch without sample weights (make_train_steps takes one): two
    ranks, whose BatchNorm sums every row with weight 1, equal one rank,
    whose BatchNorm takes the unweighted mean and variance, within 1e-10
    with dropout on."""
    inputs, _, ranks = units
    batch = {k: v for k, v in inputs["batch"].items() if k != "sample_weight"}
    out, state = _one_rank_step(inputs["weights"], batch, accum, 0.7)
    for g in (r[f"unweighted_a{accum}"] for r in ranks):
        _assert_step_equal(g, out, state, ATOL_STEP)


def test_dp_bf16_step_equals_one_rank(units):
    """The bf16 ConvStack (float32 weights, ``_BatchNormReLU`` with the
    group: its backward sums dbeta and dgamma over the ranks) at A = 2 with
    dropout on: two ranks against one, the loss within 1e-3 relative and
    the parameters' difference under 2% of the update."""
    inputs, _, ranks = units
    out, state = _one_rank_step(inputs["weights"], inputs["batch"], 2, 0.7,
                                torch.bfloat16)
    before = inputs["weights"]
    for g in (r["bf16_a2"] for r in ranks):
        diff2 = upd2 = 0.0
        for k, v in state.items():
            if v.is_floating_point():
                diff2 += float(((g["state"][k].double() - v.double()) ** 2)
                               .sum())
                upd2 += float(((v.double() - before[k]) ** 2).sum())
        np.testing.assert_allclose(float(g["loss"]), float(out.loss),
                                   rtol=RTOL_BF16_LOSS)
        assert (diff2 / upd2) ** 0.5 < BF16_UPDATE_SHARE


def test_dp_step_equals_jax_mesh(units, x64, monkeypatch):
    """Two ranks at accum_steps=2 against the JAX package's step jitted
    over its 8-device mesh (dropout patched out in both packages, tf 1.0),
    within 1e-8 in float64."""
    inputs, (params, state), ranks = units
    monkeypatch.setattr(jL, "dropout", lambda key, x, rate, train: x)
    mesh = jpar.make_mesh(8)
    opt = jstep.make_optimizer()
    t_mesh, _ = jstep.make_jitted_steps(opt, CFG, mesh=mesh, accum_steps=2)
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    p, o, s, out = t_mesh(
        jpar.put_replicated(params, mesh),
        jpar.put_replicated(opt.init(params), mesh),
        jpar.put_replicated(state, mesh), jpar.put_batch(batch, mesh),
        jax.random.PRNGKey(0), 1.0)
    ref = state_dict_from_jax(jax.tree.map(np.asarray, p),
                              jax.tree.map(np.asarray, s), TCFG)
    for g in (r["no_dropout_a2"] for r in ranks):
        _close(g["loss"], float(out.loss), ATOL_JAX)
        for k, v in out.components.items():
            _close(g["components"][k], float(v), ATOL_JAX)
        for k, v in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(g["state"][k].numpy(), v.numpy(),
                                       atol=ATOL_JAX, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", sorted(UNEVEN))
def test_dp_uneven_step_equals_one_rank(units, name):
    """Batches the JAX package trains on whose microbatches do not split
    evenly over the ranks: two ranks (one of them on stand-in rows of
    weight 0 at B=4, A=4) equal one rank within 1e-10 in float64, dropout
    on; the two ranks are identical."""
    inputs, _, ranks = units
    batch, accum = inputs["uneven"][name]
    out, state = _one_rank_step(inputs["weights"], batch, accum, 0.7)
    got = [r[f"uneven_{name}"] for r in ranks]
    for g in got:
        _assert_step_equal(g, out, state, ATOL_STEP)
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k


@pytest.mark.parametrize("name", sorted(UNEVEN))
def test_dp_uneven_step_equals_jax_mesh(units, x64, monkeypatch, name):
    """The same batches against the JAX package's step jitted over a mesh
    of two devices (dropout patched out in both packages, tf 1.0), within
    1e-8 in float64."""
    inputs, (params, state), ranks = units
    batch, accum = inputs["uneven"][name]
    monkeypatch.setattr(jL, "dropout", lambda key, x, rate, train: x)
    mesh = jpar.make_mesh(WORLD)
    opt = jstep.make_optimizer()
    t_mesh, _ = jstep.make_jitted_steps(opt, CFG, mesh=mesh,
                                        accum_steps=accum)
    p, _, s, out = t_mesh(
        jpar.put_replicated(params, mesh),
        jpar.put_replicated(opt.init(params), mesh),
        jpar.put_replicated(state, mesh),
        jpar.put_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh),
        jax.random.PRNGKey(0), 1.0)
    ref = state_dict_from_jax(jax.tree.map(np.asarray, p),
                              jax.tree.map(np.asarray, s), TCFG)
    for g in (r[f"uneven_{name}_no_dropout"] for r in ranks):
        _close(g["loss"], float(out.loss), ATOL_JAX)
        for k, v in out.components.items():
            _close(g["components"][k], float(v), ATOL_JAX)
        for k, v in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(g["state"][k].numpy(), v.numpy(),
                                       atol=ATOL_JAX, rtol=0, err_msg=k)


def test_dp_step_rejects_indivisible_batch(units):
    """B = 6 at A = 4 on two ranks, a batch the JAX package refuses too:
    every rank raises before any collective, naming B, A and N."""
    for r in units[2]:
        assert "B=6, A=4, N=2" in r["b6_error"]


def test_checkpoint_choice_is_rank0s(units):
    """Which checkpoint the Trainer restores (restore broadcasts the
    weights) is rank 0's, whatever the other ranks find on their disk; a
    path that some rank cannot see fails on every rank."""
    for r in units[2]:  # rank 0 held the work folder, rank 1 None
        assert os.path.isdir(r["paths"]["rank0_path"])
        assert r["paths"]["rank0_none"] is None
        assert "missing on 2 rank(s)" in r["paths"]["missing"]


def test_dp_eval_stops_on_every_rank(units):
    """Eval under data parallelism on a weak model: the predictions and the
    loss equal one rank's on the whole batch (the decode stops when every
    rank's items have stopped, as JAX's one loop over the global batch);
    each rank stopping on its own rows would differ."""
    inputs, _, ranks = units
    model = tst.ScoreTranscription(TCFG).double()
    model.load_state_dict(inputs["weak_weights"], strict=True)
    _, e_step = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), device="cpu")
    out, preds = e_step(model, inputs["eval_batch"])
    for r in ranks:
        for k, v in preds.items():
            assert torch.equal(r["eval"]["preds"][k], v), k
        _close(r["eval"]["loss"], out.loss, ATOL_STEP)
        for k, v in out.components.items():
            _close(r["eval"]["components"][k], v, ATOL_STEP)
    local = {k: torch.cat([r["eval_local_stop"][k] for r in ranks])
             for k in preds}
    assert any(not torch.equal(local[k], preds[k]) for k in preds)


# --- the Trainer (one launch of two ranks) -------------------------------

TRAINER_EXP = dict(seed=7, max_length=(8, 6), max_bars=2, max_duration=1,
                   frames_per_second=23, bins_per_octave=4, n_octaves=4,
                   number_of_epochs=1, batch_size=8, conv_feature_size=16,
                   hidden_size=16, note_emb_size=8, staff_emb_size=8)
# run: (per-host sharded loading, accum_steps, a loader seed per rank)
TRAINER_RUNS = {"replicated": (False, 1, False), "sharded": (True, 2, False),
                "mismatch": (False, 1, True),
                "mismatch_sharded": (True, 1, True)}


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("dp_trainer"))
    features = os.path.join(workdir, "features")
    _make_fixture(features, "train", 0, n_songs=8)
    _make_fixture(features, "valid", 0, n_songs=2, seed=1)
    with open(os.path.join(workdir, "trainer.json"), "w") as f:
        json.dump({"exp": TRAINER_EXP, "runs": TRAINER_RUNS}, f)
    _launch(workdir, "trainer")
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"trainer_{r}.json")) as f:
            ranks.append(json.load(f))
    return workdir, ranks


def _one_process_trainer(workdir, accum):
    out = os.path.join(workdir, f"single_a{accum}")
    features = os.path.join(workdir, "features")
    exp = ExperimentConfig(workspace=workdir, output_folder=out,
                           feature_folder=features,
                           save_folder=os.path.join(out, "save"),
                           train_log=os.path.join(out, "train_log.txt"),
                           **TRAINER_EXP)
    exp.extras["accum_steps"] = accum
    train = SyntheticTrainDataset(features, "train", versions=[0],
                                  max_frame_num=exp.max_frame_num,
                                  max_length=exp.max_length,
                                  rng=np.random.RandomState(0))
    valid = SyntheticTestDataset(features, "valid", versions=[0],
                                 max_frame_num=exp.max_frame_num,
                                 max_length=exp.max_length)
    trainer = Trainer(exp, device="cpu")
    trainer.fit(DataLoader(train, 8, shuffle=True, seed=0),
                DataLoader(valid, 8))
    state = trainer.model.state_dict()
    return (trainer.train_stats["loss"],
            float(sum(v.double().sum() for v in state.values())), out)


@pytest.mark.parametrize("run", ["replicated", "sharded"])
def test_two_process_trainer_matches_one_process(trainer_runs, run):
    """The twins of tests/test_multihost.py's two training tests: both
    ranks give identical results, equal to one process's Trainer (at
    accum_steps 1, replicated loading; at 2, sharded loading, each rank
    reading half the features); rank 0 alone wrote the log, the one
    checkpoint and the result records, identical to one process's."""
    workdir, ranks = trainer_runs
    got = [r[run] for r in ranks]
    assert got[0]["train_loss"] == got[1]["train_loss"]
    assert got[0]["param_sum"] == got[1]["param_sum"]
    assert [g["is_main"] for g in got] == [True, False]
    if run == "sharded":
        assert [g["train_feature_loads"] for g in got] == [4, 4]
    accum = TRAINER_RUNS[run][1]
    loss, param_sum, single = _one_process_trainer(workdir, accum)
    np.testing.assert_allclose(got[0]["train_loss"], loss,
                               rtol=RTOL_TRAINER_LOSS)
    np.testing.assert_allclose(got[0]["param_sum"], param_sum,
                               rtol=RTOL_TRAINER_PARAMS)
    out = os.path.join(workdir, run)
    ckpts = [d for d in os.listdir(os.path.join(out, "save"))
             if d.startswith("CKPT")]
    assert len(ckpts) == 1
    log = open(os.path.join(out, "train_log.txt")).read()
    assert log.count("epoch: 1") == 1
    for split_dir in ("results/valid",):
        names = sorted(os.listdir(os.path.join(out, split_dir)))
        assert names == sorted(os.listdir(os.path.join(single, split_dir)))
        assert len(names) == 2
        for name in names:
            with open(os.path.join(out, split_dir, name)) as f:
                pred = json.load(f)["pred"]
            with open(os.path.join(single, split_dir, name)) as f:
                assert pred == json.load(f)["pred"]


@pytest.mark.parametrize("run", ["mismatch", "mismatch_sharded"])
def test_mismatched_batches_fail_loudly(trainer_runs, run):
    """The twins of tests/test_multihost.py's mismatch tests: ranks whose
    loaders draw different batches (replicated or sharded) all fail on
    the first batch with "batch mismatch" instead of training on it."""
    for r in trainer_runs[1]:
        assert "batch mismatch" in r[run]["error"]


def test_trainer_use_mesh_needs_a_group(tmp_path):
    exp = ExperimentConfig(workspace=str(tmp_path),
                           output_folder=str(tmp_path / "o"),
                           save_folder=str(tmp_path / "o" / "save"),
                           train_log=str(tmp_path / "o" / "log.txt"),
                           **TRAINER_EXP)
    with pytest.raises(ValueError, match="process group"):
        Trainer(exp, device="cpu", use_mesh=True)


# --- the command under torchrun -------------------------------------------

def test_pretrain_command_data_parallel_under_torchrun(tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    piano_a2s_tpu_torch.cli.pretrain ... --data-parallel --device cpu on a
    tiny corpus of clips: both ranks exit 0, the batch is 2 x 2, rank 0
    alone prints the stats and writes the log, the checkpoint and the
    result records."""
    from piano_a2s_tpu_torch.train.synthetic import write_clips
    from test_torch_harness import CLI_YAML
    root = str(tmp_path)
    kw = dict(samples=(2500, 3800), upper=(1, 7), lower=(1, 5), bars=2)
    for split, n in (("train", 4), ("valid", 2), ("test", 2)):
        write_clips(os.path.join(root, "synth", split, "0"), n,
                    seed=len(split), **kw)
    yaml_path = str(tmp_path / "tiny.yaml")
    with open(yaml_path, "w") as f:
        f.write(CLI_YAML.format(root=root))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), "-m",
         "piano_a2s_tpu_torch.cli.pretrain", yaml_path, "version=pre",
         "corpus=synth", "number_of_epochs=1", "--data-parallel",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=REPO_ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("key_f1") == 1
    pre = os.path.join(root, "pre")
    with open(os.path.join(pre, "hyperparams.yaml")) as f:
        assert "batch_size: 2" in f.read()
    log = open(os.path.join(pre, "train_log.txt")).read()
    assert log.count("epoch: 1") == 1 and log.count("stage: test") == 1
    assert len([d for d in os.listdir(os.path.join(pre, "save"))
                if d.startswith("CKPT")]) == 1
    for split in ("valid", "test"):
        assert len(os.listdir(os.path.join(pre, "results", split))) == 2
