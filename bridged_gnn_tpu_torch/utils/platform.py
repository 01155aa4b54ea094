"""Device selection and matmul precision for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

# JAX's matmul precision names (jax.default_matmul_precision) and whether
# the card's f32 matmuls run in TF32 under each: "default" and "bfloat16"
# are both Precision.DEFAULT, which XLA runs in TF32 on an NVIDIA card.
MATMUL_TF32 = {None: False, "highest": False, "float32": False,
               "default": True, "bfloat16": True}


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Entry points default to the card. Asking for CUDA on a machine
    without one raises instead of carrying on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but "
            "torch.cuda.is_available() is false; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


def check_matmul_precision(name: Optional[str]) -> None:
    """Raise ``ValueError`` unless ``name`` is one of JAX's precision
    names (or None)."""
    if name not in MATMUL_TF32:
        raise ValueError(f"matmul_precision must be one of "
                         f"{list(MATMUL_TF32)}, got {name!r}")


@contextlib.contextmanager
def matmul_precision(name: Optional[str]):
    """Run the block under JAX's matmul precision ``name``: TF32 for the
    card's f32 matmuls (cuBLAS) under ``"default"`` and ``"bfloat16"``,
    full f32 under None, ``"highest"`` and ``"float32"``. Sets only the
    CUDA backend's flag (``torch.backends.cuda.matmul.allow_tf32``; CPU
    matmuls stay f32) and restores its previous value on exit. The port's
    own kernels use no tensor cores, so this touches the linears alone."""
    check_matmul_precision(name)
    cublas = torch.backends.cuda.matmul
    before = cublas.allow_tf32
    cublas.allow_tf32 = MATMUL_TF32[name]
    try:
        yield
    finally:
        cublas.allow_tf32 = before
