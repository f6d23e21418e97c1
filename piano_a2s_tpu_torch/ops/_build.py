"""Build the package's CUDA sources with nvcc at first use, and load them.

Each ``csrc/<name>.cu`` has a plain C interface, so it compiles in seconds
into a shared library that ctypes loads; nothing includes PyTorch's headers.
The library goes to ``build/piano_a2s_tpu_torch/`` beside the package, under
a name that carries a hash of the source and flags, so an edited source is
rebuilt and an unchanged one is reused.
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


def build(name: str, build_dir: str = BUILD_DIR) -> Build:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(build_dir, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return Build(lib, 0.0, "")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.monotonic()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
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
