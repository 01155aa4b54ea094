"""Finite-state guard (port of ``assert_all_finite`` from
``bridged_gnn_tpu/utils/sanitizers.py``, for tensors and numpy arrays).

The trainer's ``check_numerics`` runs it on the losses, the parameters and
the batch-norm statistics at every epoch of the loop and at every chunk
boundary of scan mode.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for every tensor or array in nested dicts, lists
    and tuples, in their order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first floating leaf of
    ``tree`` that holds a NaN or an infinity. Tensors are checked where
    they lie; the verdicts reach the host in one copy."""
    floats = []
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf) if not torch.is_tensor(leaf) else leaf
        if t.is_floating_point():
            floats.append((path, t))
    if not floats:
        return
    # gather the verdicts on a card if any leaf lies there
    dev = next((t.device for _, t in floats if t.device.type != "cpu"),
               torch.device("cpu"))
    finite = torch.stack([torch.isfinite(t).all().to(dev)
                          for _, t in floats]).cpu().numpy()
    if not finite.all():
        path = floats[int(np.argmin(finite))][0]
        raise FloatingPointError(f"non-finite values in {name} at {path}")
