"""Build the package's CUDA sources with nvcc at first use, and load them.

Each ``csrc/<name>.cu`` has a plain C interface, so it compiles in seconds
into a shared library that ctypes loads; nothing includes PyTorch's headers.
The library goes to ``build/piano_a2s_tpu_torch/`` beside the package, under
a name that carries a hash of every file under ``csrc/`` (any of them may be
included) and of the flags, so an edited source or header is rebuilt and an
unchanged tree is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                         "piano_a2s_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# After the source on the command line; libcuda holds cuTensorMapEncodeTiled.
NVCC_LIBS = ("-lcuda",)

_lock = threading.Lock()
_loaded: dict = {}


@dataclass(frozen=True)
class Build:
    path: str        # the shared library
    seconds: float   # nvcc wall time; 0.0 when a cached library was reused
    log: str         # nvcc's output (ptxas register and shared-memory use)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the package's kernels")
    return path


def source_digest(csrc_dir: str = CSRC_DIR) -> str:
    """Hash of the flags and of every file under ``csrc_dir``."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *NVCC_LIBS)).encode())
    for root, dirs, files in os.walk(csrc_dir):
        dirs.sort()
        for fname in sorted(files):
            path = os.path.join(root, fname)
            h.update(b"\0" + os.path.relpath(path, csrc_dir).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build(name: str, build_dir: str = BUILD_DIR,
          csrc_dir: str = CSRC_DIR) -> Build:
    """Compile ``<csrc_dir>/<name>.cu`` unless an up-to-date library
    exists."""
    src = os.path.join(csrc_dir, f"{name}.cu")
    lib = os.path.join(build_dir,
                       f"lib{name}_{source_digest(csrc_dir)}.so")
    if os.path.exists(lib):
        return Build(lib, 0.0, "")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.monotonic()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src, *NVCC_LIBS],
                          capture_output=True, text=True, timeout=600)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return Build(lib, seconds, proc.stdout + proc.stderr)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name).path)
        return _loaded[name]
