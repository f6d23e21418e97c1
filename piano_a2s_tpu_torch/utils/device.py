"""Device selection and the float32 precision settings of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist.

    There is no silent fallback: the CPU is used only when asked for.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available (pass device='cpu' to run on the CPU)")
    return dev


def use_full_float32() -> None:
    """Keep float32 matmuls and cuDNN convolutions/RNNs out of TF32, and
    bfloat16 matmuls' split-K partial sums in float32.

    The JAX package is the float32 reference. PyTorch's cuDNN paths default
    to TF32, which moves the conv features by about 1e-3 relative. cuBLAS
    may by default reduce a bfloat16 product's split-K partial sums in
    bfloat16; the TPU's MXU and XLA:CPU accumulate bfloat16 products in
    float32, so the bf16 paths must too.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
