"""The port never imports jax nor the JAX package, and it never falls back
to the CPU.

The import checks run in a subprocess: this test process has jax and the
JAX package loaded already (tests/conftest.py)."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

from conftest import REPO_ROOT
from piano_a2s_tpu_torch.infer import Transcriber
from piano_a2s_tpu_torch.models import ModelConfig, init_state_dict
from piano_a2s_tpu_torch.utils.device import resolve_device

PACKAGE = "piano_a2s_tpu_torch"


def _port_modules():
    root = os.path.join(REPO_ROOT, PACKAGE)
    mods = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO_ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _import_in_fresh_process(mods):
    """Import ``mods`` in a new interpreter; fail if jax or any module of
    the JAX package (piano_a2s_tpu, piano_a2s_tpu.*) got loaded."""
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'piano_a2s_tpu'\n"
            "             or m.startswith('piano_a2s_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_port_imports_no_jax():
    mods = _port_modules()
    assert f"{PACKAGE}.ops.vqt_cuda" in mods and f"{PACKAGE}.serve" in mods
    assert f"{PACKAGE}.train.step" in mods
    _import_in_fresh_process(mods)


def _chip_smoke_imports():
    """Every module chip_smoke.py imports, at top level or in a function."""
    tree = ast.parse(open(os.path.join(REPO_ROOT, "chip_smoke.py")).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return sorted(mods)


def test_chip_smoke_imports_no_jax():
    mods = _chip_smoke_imports()
    assert f"{PACKAGE}.train.step" in mods
    _import_in_fresh_process(mods + ["chip_smoke"])


_JAX_PACKAGE_IMPORT = re.compile(r"(from|import) piano_a2s_tpu(\.| |$)",
                                 re.MULTILINE)


def test_no_source_imports_the_jax_package():
    files = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO_ROOT, PACKAGE)):
        files += [os.path.join(dirpath, f) for f in names
                  if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        src = open(path).read()
        assert not _JAX_PACKAGE_IMPORT.search(src), path
    assert _JAX_PACKAGE_IMPORT.search("from piano_a2s_tpu.serve import x")
    assert _JAX_PACKAGE_IMPORT.search("import piano_a2s_tpu")
    assert not _JAX_PACKAGE_IMPORT.search("from piano_a2s_tpu_torch import x")


def test_no_kernel_library_or_compile_in_port():
    banned = ("torch.compile", "scaled_dot_product_attention", "import jax",
              "from jax", "except Exception")
    root = os.path.join(REPO_ROOT, PACKAGE)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                for word in banned:
                    assert word not in src, (f, word)


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    cfg = ModelConfig(freq_bins=12, conv_feature_size=8, hidden_size=8,
                      max_bars=1, max_length=(4, 3), note_emb_size=4,
                      staff_emb_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transcriber(init_state_dict(cfg), cfg, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
