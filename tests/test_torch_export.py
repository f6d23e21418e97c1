"""The port's checkpoint export (cli/export_checkpoint.py) against the JAX
package's scripts/export_reference_checkpoint.py on the CPU.

The same reference-format weights go into a save folder of each package
(scripts/convert_reference_checkpoint.py for the JAX package,
cli.import_checkpoint for the port), two checkpoints each: WER 43.5, then a
later one at WER 77.0. Both exports must then write the same tensors
(``num_batches_tracked`` included, 0 in both) under the same keys, and
CKPT.yaml files with the same keys, WER and loss, for the best checkpoint,
``--latest`` and ``--modulelist``. The reference-format source is written
from the port's random weights: its parameter names are the reference's.
"""

import os
import runpy
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import REPO_ROOT
from piano_a2s_tpu_torch.cli import export_checkpoint, import_checkpoint
from piano_a2s_tpu_torch.models import score_transcription as tst
from piano_a2s_tpu_torch.models.convert import init_state_dict
from piano_a2s_tpu_torch.train.checkpoint import Checkpointer
from test_convert_cli import TINY_YAML

JAX_CONVERT = os.path.join(REPO_ROOT, "scripts",
                           "convert_reference_checkpoint.py")
JAX_EXPORT = os.path.join(REPO_ROOT, "scripts",
                          "export_reference_checkpoint.py")
# tests/test_convert_cli.py's model: TINY_YAML's shape.
TCFG = tst.ModelConfig(freq_bins=16, conv_feature_size=16, hidden_size=16,
                       max_bars=2, max_length=(6, 5), note_emb_size=8,
                       staff_emb_size=8)
SOURCES = (("CKPT+better", 43.5, 3), ("CKPT+worse", 77.0, 4))


def _jax_script(path, args):
    """Run one of the JAX package's scripts in this process, as its command
    line would (sys.argv patched)."""
    argv = sys.argv
    sys.argv = [path] + args
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv


def _run(args):
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=300, cwd=REPO_ROOT)


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """A reference save folder of two checkpoints, imported one after the
    other into a save folder of each package."""
    root = str(tmp_path_factory.mktemp("export"))
    cfg_path = os.path.join(root, "tiny.yaml")
    with open(cfg_path, "w") as f:
        f.write(TINY_YAML.format(out=os.path.join(root, "out"),
                                 save=os.path.join(root, "out", "save")))
    src, weights = os.path.join(root, "ref_save"), {}
    for tag, wer, seed in SOURCES:
        sd = init_state_dict(TCFG, seed)
        for k in sd:
            if k.endswith("num_batches_tracked"):
                sd[k] = torch.tensor(5 + seed)
        os.makedirs(os.path.join(src, tag))
        torch.save(sd, os.path.join(src, tag, "model.ckpt"))
        with open(os.path.join(src, tag, "CKPT.yaml"), "w") as f:
            f.write(f"WER: {wer}\nunixtime: 1700000000.0\n")
        weights[tag] = sd
    jax_save = os.path.join(root, "jax_save")
    port_save = os.path.join(root, "port_save")
    for tag, _, _ in SOURCES:
        _jax_script(JAX_CONVERT, [os.path.join(src, tag), "--config",
                                  cfg_path, "--out", jax_save])
        assert import_checkpoint.main([os.path.join(src, tag), "--config",
                                       cfg_path, "--out", port_save]) == 0
    return root, cfg_path, jax_save, port_save, weights


def _read_yaml(path):
    with open(os.path.join(path, "CKPT.yaml")) as f:
        return dict(line.rstrip("\n").split(": ", 1) for line in f)


def _load(path):
    return torch.load(os.path.join(path, "model.ckpt"), map_location="cpu",
                      weights_only=True)


@pytest.mark.parametrize("flags", [[], ["--latest"], ["--modulelist"]],
                         ids=["best", "latest", "modulelist"])
def test_export_equals_jax_script(saves, flags, capsys):
    root, cfg_path, jax_save, port_save, weights = saves
    name = "_".join(flags) or "best"
    jax_out = os.path.join(root, f"jax_{name}")
    port_out = os.path.join(root, f"port_{name}")
    capsys.readouterr()
    _jax_script(JAX_EXPORT, [jax_save, "--config", cfg_path, "--out",
                             jax_out] + flags)
    jax_printed = capsys.readouterr().out.splitlines()
    assert export_checkpoint.main([port_save, "--config", cfg_path, "--out",
                                   port_out] + flags) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("exporting ")
    assert printed[0].endswith(jax_printed[0].split(" (")[-1])
    assert printed[1] == jax_printed[1].replace(jax_out, port_out)

    ref, got = _load(jax_out), _load(port_out)
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    tag = "CKPT+worse" if flags == ["--latest"] else "CKPT+better"
    prefix = "0." if flags == ["--modulelist"] else ""
    for k, v in weights[tag].items():
        want = (torch.tensor(0) if k.endswith("num_batches_tracked")
                else v)
        assert torch.equal(got[prefix + k], want), k
    y_ref, y_got = _read_yaml(jax_out), _read_yaml(port_out)
    assert list(y_got) == list(y_ref) == ["WER", "loss", "unixtime",
                                          "exported_from"]
    assert (y_got["WER"], y_got["loss"]) == (y_ref["WER"], y_ref["loss"])
    assert y_got["WER"] == ("77.0" if tag == "CKPT+worse" else "43.5")


def test_modulelist_export_round_trips_through_import(saves):
    """--modulelist, then cli.import_checkpoint of the exported directory:
    the same model state as the exported checkpoint, and the WER kept."""
    root, cfg_path, _, port_save, _ = saves
    out, again = os.path.join(root, "ml"), os.path.join(root, "again")
    assert export_checkpoint.main([port_save, "--config", cfg_path, "--out",
                                   out, "--modulelist"]) == 0
    assert import_checkpoint.main([out, "--config", cfg_path, "--out",
                                   again]) == 0
    ckpt = Checkpointer(again)
    trees, _, meta = ckpt.load(ckpt.best_path(), ("model",))
    src, _, _ = Checkpointer(port_save).load(
        Checkpointer(port_save).best_path(), ("model",))
    assert list(trees["model"]) == list(src["model"])
    for k, v in src["model"].items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(trees["model"][k], v), k
    assert meta["WER"] == 43.5


def test_no_checkpoints_exits_as_jax_script(tmp_path):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    cfg = os.path.join(REPO_ROOT, "configs", "pretrain.yaml")
    with pytest.raises(SystemExit) as jax_exit:
        _jax_script(JAX_EXPORT, [empty, "--config", cfg])
    with pytest.raises(SystemExit) as port_exit:
        export_checkpoint.main([empty, "--config", cfg])
    assert port_exit.value.code == jax_exit.value.code \
        == f"no checkpoints under {empty}"


def test_default_out_is_swept_by_the_next_save(saves):
    """The command with the default --out writes CKPT+export-<time> into
    the save folder; that directory holds no meta.json, so the next
    save_and_keep_only deletes it, as the JAX package's does (--help says
    so)."""
    root, cfg_path, _, src, _ = saves
    port_save = os.path.join(root, "swept")
    shutil.copytree(src, port_save)
    r = _run(["-m", "piano_a2s_tpu_torch.cli.export_checkpoint", port_save,
              "--config", cfg_path])
    assert r.returncode == 0, r.stdout + r.stderr
    exported = [d for d in os.listdir(port_save)
                if d.startswith("CKPT+export-")]
    assert len(exported) == 1
    assert os.path.exists(os.path.join(port_save, exported[0], "model.ckpt"))
    assert "deletes it" in export_checkpoint.OUT_HELP
    ckpt = Checkpointer(port_save)
    trees, host, _ = ckpt.load(ckpt.best_path(), ("model",))
    ckpt.save_and_keep_only(trees, {"WER": 1.0}, host)
    assert not os.path.exists(os.path.join(port_save, exported[0]))
