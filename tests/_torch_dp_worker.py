"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py).

    python _torch_dp_worker.py <rank> <world> <init file> <workdir> <mode>

The ranks join a gloo group through ``file://<init file>`` (no port to
race for) on the CPU. This process imports torch and the port, never jax.

mode "units": reads <workdir>/inputs.pt (weights, batches, BatchNorm
cases, all float64) and writes <workdir>/units_<rank>.pt: the BatchNorm
functions' outputs and gradients on this rank's rows; a train_step and a
train_step_accum (A=2) with dropout on, with and without the row
weights, the latter also with the bf16 ConvStack (float32 weights), and
one (A=2) with dropout patched out; the uneven batches (B=6 at A=2, B=4 at
A=4, also with row 0 weighing 0), with dropout on and patched out; the eval step on a weak model with
the global stop and, for contrast, with this rank's own stop; the error of
a batch of 6 at A=4; ``parallel.broadcast_path`` with rank 0 and rank 1
holding different paths.

mode "trainer": reads <workdir>/trainer.json and fits the port's Trainer
(use_mesh=True) on the spectrogram fixture in <workdir>/features four
times: replicated loading, per-host sharded loading with accum_steps=2,
and both again with a loader seed per rank, which must fail with "batch
mismatch". Writes <workdir>/trainer_<rank>.json.
"""

import json
import os
import sys
import traceback

rank_, world_, init_file, workdir, mode = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5])

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import piano_a2s_tpu_torch.ops.layers as tL  # noqa: E402
from piano_a2s_tpu_torch import parallel  # noqa: E402

torch.set_num_threads(1)


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _step_out(out):
    return {"loss": out.loss.detach().clone(),
            "components": {k: v.detach().clone()
                           for k, v in out.components.items()},
            "grad_norm": out.grad_norm.detach().clone()}


def _make_bn(case):
    """The case's BatchNorm module: 2-D over (B, C, H, W) with axes
    (0, 2, 3), or 1-D over (B, T, F) with axes (0, 1), float64."""
    cls = (torch.nn.BatchNorm2d if case["x"].dim() == 4
           else torch.nn.BatchNorm1d)
    bn = cls(case["bn_state"]["weight"].numel()).double()
    bn.load_state_dict(case["bn_state"])
    return bn


def _bn_cases(inputs, group):
    """Each BatchNorm case on this rank's rows: (output rows, x's
    gradient rows, gamma's and beta's gradients from this rank, running
    statistics)."""
    out = {}
    for name, case in inputs["bn_cases"].items():
        rows = parallel.local_rows(rank_, world_, case["x"].shape[0])
        for fn_name, fn in (("batch_norm_train", tL.batch_norm_train),
                            ("batch_norm_relu_train",
                             tL.batch_norm_relu_train)):
            bn = _make_bn(case)
            x = case["x"][rows].clone().requires_grad_(True)
            y = fn(x, bn, case["axes"], case["weight"][rows], group=group)
            (y * case["cotangent"][rows]).sum().backward()
            out[(name, fn_name)] = {
                "y": y.detach(), "dx": x.grad, "dgamma": bn.weight.grad,
                "dbeta": bn.bias.grad, "running_mean": bn.running_mean,
                "running_var": bn.running_var}
    return out


def units():
    from piano_a2s_tpu_torch.models import score_transcription as tst
    from piano_a2s_tpu_torch.train import step as tstep

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    group = dist.group.WORLD
    cfg = tst.ModelConfig(**inputs["cfg"])
    result = {"bn": _bn_cases(inputs, group)}

    def model_of(state_dict):
        model = tst.ScoreTranscription(cfg).double()
        model.load_state_dict(state_dict, strict=True)
        return model

    def train(name, state_dict, batch, accum, tf, conv_dtype=None):
        model = model_of(state_dict)
        if conv_dtype is not None:
            model = model.float()
        t_step, _ = tstep.make_train_steps(
            tstep.make_optimizer(model.parameters()), accum_steps=accum,
            device="cpu", group=group, conv_dtype=conv_dtype)
        out = t_step(model, batch, torch.Generator().manual_seed(0), tf)
        result[name] = dict(_step_out(out), state=_state(model))

    unweighted = {k: v for k, v in inputs["batch"].items()
                  if k != "sample_weight"}
    for accum in (1, 2):
        train(f"dropout_a{accum}", inputs["weights"], inputs["batch"],
              accum, 0.7)
        train(f"unweighted_a{accum}", inputs["weights"], unweighted, accum,
              0.7)
    train("bf16_a2", inputs["weights"], inputs["batch"], 2, 0.7,
          torch.bfloat16)
    for name, (batch, accum) in inputs["uneven"].items():
        train(f"uneven_{name}", inputs["weights"], batch, accum, 0.7)
    dropout = tL.dropout
    tL.dropout = lambda x, rate, train, generator=None, rows=None: x
    try:
        train("no_dropout_a2", inputs["weights"], inputs["batch"], 2, 1.0)
        for name, (batch, accum) in inputs["uneven"].items():
            train(f"uneven_{name}_no_dropout", inputs["weights"], batch,
                  accum, 1.0)
    finally:
        tL.dropout = dropout

    model = model_of(inputs["weak_weights"])
    _, e_step = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), device="cpu", group=group)
    out, preds = e_step(model, inputs["eval_batch"])
    result["eval"] = {"loss": out.loss, "components": out.components,
                      "preds": preds}
    # This rank's rows with its own stop: what the global stop prevents.
    rows = parallel.local_rows(rank_, world_,
                               inputs["eval_batch"]["time_sig"].shape[0])
    mine = {k: np.asarray(v)[rows] for k, v in inputs["eval_batch"].items()}
    _, e_local = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), device="cpu")
    result["eval_local_stop"] = e_local(model, mine)[1]

    model = model_of(inputs["weights"])
    t_step, _ = tstep.make_train_steps(
        tstep.make_optimizer(model.parameters()), accum_steps=4,
        device="cpu", group=group)
    six = {k: np.asarray(v)[:6] for k, v in inputs["batch"].items()}
    try:
        t_step(model, six, torch.Generator().manual_seed(0), 0.7)
        result["b6_error"] = None
    except ValueError as exc:
        result["b6_error"] = str(exc)
    # The checkpoint to restore is rank 0's choice, whatever this rank sees.
    mine = workdir if rank_ else None
    result["paths"] = {
        "rank0_path": parallel.broadcast_path(workdir if rank_ == 0 else None,
                                              group),
        "rank0_none": parallel.broadcast_path(mine, group)}
    try:
        parallel.broadcast_path(os.path.join(workdir, "absent") if rank_ == 0
                                else workdir, group)
        result["paths"]["missing"] = None
    except RuntimeError as exc:
        result["paths"]["missing"] = str(exc)
    torch.save(result, os.path.join(workdir, f"units_{rank_}.pt"))


def trainer():
    from piano_a2s_tpu_torch.config import ExperimentConfig
    from piano_a2s_tpu_torch.data.datasets import (DataLoader,
                                                   SyntheticTestDataset,
                                                   SyntheticTrainDataset)
    from piano_a2s_tpu_torch.train.harness import Trainer

    with open(os.path.join(workdir, "trainer.json")) as f:
        spec = json.load(f)
    features = os.path.join(workdir, "features")
    result = {}
    for run, (sharded, accum, mismatch) in spec["runs"].items():
        out = os.path.join(workdir, run)
        exp = ExperimentConfig(
            workspace=workdir, output_folder=out, feature_folder=features,
            save_folder=os.path.join(out, "save"),
            train_log=os.path.join(out, "train_log.txt"), **spec["exp"])
        exp.extras["accum_steps"] = accum
        train_ds = SyntheticTrainDataset(
            features, "train", versions=[0], max_frame_num=exp.max_frame_num,
            max_length=exp.max_length, rng=np.random.RandomState(0))
        valid_ds = SyntheticTestDataset(
            features, "valid", versions=[0], max_frame_num=exp.max_frame_num,
            max_length=exp.max_length)
        loads = {"n": 0}
        load_spec = train_ds.load_spectrogram

        def counting(locator, load_spec=load_spec, loads=loads):
            loads["n"] += 1
            return load_spec(locator)

        train_ds.load_spectrogram = counting
        train_loader = DataLoader(
            train_ds, exp.batch_size, shuffle=True,
            seed=rank_ if mismatch else 0,
            shard=(rank_, world_) if sharded else None, accum_steps=accum)
        trainer = Trainer(exp, device="cpu", use_mesh=True)
        try:
            trainer.fit(train_loader, DataLoader(valid_ds, exp.batch_size))
        except ValueError as exc:
            result[run] = {"error": str(exc)}
            continue
        state = trainer.model.state_dict()
        result[run] = {
            "train_loss": trainer.train_stats["loss"],
            "param_sum": float(sum(v.double().sum() for v in state.values())),
            "is_main": trainer.is_main_process,
            "train_feature_loads": loads["n"]}
    with open(os.path.join(workdir, f"trainer_{rank_}.json"), "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    parallel.distributed_init(init_method=f"file://{init_file}", rank=rank_,
                              world_size=world_, device="cpu",
                              timeout_s=240)
    try:
        {"units": units, "trainer": trainer}[mode]()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # a rank that failed must not wait on the others
    parallel.shutdown()
    print(f"[rank {rank_}] {mode} done", flush=True)
