"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


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
